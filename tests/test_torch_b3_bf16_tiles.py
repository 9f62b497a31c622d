"""A model of kernel B3-bf16's staging and tensor-core sums, held against
the data gradient on the CPU.

The kernel (``rave_tpu_torch/csrc/ci1_conv.cu``, ``ci1_dx_bf16_mma_kernel``)
cannot run here, but its index arithmetic can: this file replays it with
torch on bf16 values.  A persistent grid's warps each take a contiguous
share of the (batch row, 128-step tile) pairs and load each pair's groups
of 16 channel rows in turn into a ring of slots.  A slot holds 19 pieces
of 8 values of each row from the window start ``ts = t0 - pad_right``
rounded down to a 16-byte boundary of g (``S_c`` values before it), zeros
outside [0, T): one TMA box (innermost start a multiple of 8, zeros
outside the (T, co, B) tensor) where T % 8 == 0 and g is 16-byte aligned,
16-byte cp.async pieces elsewhere, the pieces that straddle [0, T)
assembled with zeros (``misalign0`` is the misalignment, in values, of
g's first element).  The warp reads A by ``ldmatrix.x4`` from the Hankel
view of a row (block m of K-half h at pieces m + 2h and m + 2h + 1),
builds B, the banded reversed taps at ``S_c``, from a zero-padded table
(rebuilt where a batch row starts, or for every group where co > 16),
sums one m16n8k16 product per channel and K-half into four chains and
stores its fragment's outputs, masked at T.

The model must agree with the bf16 contract (float32 arithmetic on the
bf16 operands, rounded once) and with ``conv1d_ci1_dx_reference`` within
1 ulp of max |y| (the tensor cores sum in another order), as the kernel
must on the card (``chip_smoke.CI1_BF16_ULPS``), and in one case with the
JAX package's ``_pallas_dx`` run in interpret mode on bf16.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.ops.pallas.ci1_conv import _pallas_dx
from rave_tpu_torch.ops.kernels import ci1_conv as ci

BF = torch.bfloat16
SOURCE = (Path(ci.__file__).resolve().parents[2] / "csrc"
          / "ci1_conv.cu").read_text()


def constants() -> dict:
    """B3-bf16's ``constexpr int kB3*`` constants (and kMaxCo), evaluated
    from the source."""
    found = {"kMaxCo": int(re.search(r"constexpr int kMaxCo = (\d+);",
                                     SOURCE)[1])}
    for name, expr in re.findall(r"constexpr int (kB3\w+) =\s*([^;]+);",
                                 SOURCE):
        found[name] = eval(expr.replace("/", "//"), {}, dict(found))
    return found


C = constants()
TILE, ROWS, PIECES, COLS = (C["kB3Tile"], C["kB3Rows"], C["kB3Pieces"],
                            C["kB3Cols"])
WARPS, STAGES, CTAS_PER_SM = C["kB3Warps"], C["kB3Stages"], C["kB3CtasPerSm"]
TAP_COLS, TAP_OFF = C["kB3TapCols"], C["kB3TapOff"]
SM_BYTES = 228 * 1024      # an H100 SM's shared memory for its CTAs
CTA_RESERVED = 1024        # the runtime's shared memory of each CTA


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lanes():
    lane = torch.arange(32)
    return lane >> 2, lane & 3                  # gid, tig


def ldsm_pieces(h):
    """The piece of a staged row that lane l gives ``ldmatrix.x4`` for
    K-half h (the kernel's ``lane_piece`` plus 2 h): row l % 8 of matrix
    l / 8, A's blocks 0-7 or 8-15 and K columns 0-7 or 8-15."""
    lane = torch.arange(32)
    return (lane & 7) + 8 * ((lane >> 3) & 1) + (lane >> 4) + 2 * h


def ldmatrix(row, pieces):
    """``ldmatrix.x4`` (no transpose) of 8 x 8 matrices whose rows are the
    16-byte pieces ``pieces`` (lane l: row l % 8 of matrix l / 8) of a
    staged row; returns regs[lane, matrix, half]."""
    m = row[(8 * pieces[:, None] + torch.arange(8))].reshape(4, 8, 8)
    gid, tig = lanes()
    i = torch.arange(4)[None, :]
    lo, hi = m[i, gid[:, None], 2 * tig[:, None]], m[i, gid[:, None],
                                                     2 * tig[:, None] + 1]
    return torch.stack([lo, hi], -1)            # (32, 4, 2)


def a_from_fragments(regs):
    """mma.m16n8k16's A (16 x 16, row) from a warp's fragments: lane
    (gid, tig), reg 0 row gid, columns 2 tig, + 1; reg 1 rows + 8; reg 2
    columns + 8; reg 3 both."""
    a = torch.zeros(16, 16, dtype=regs.dtype)
    gid, tig = lanes()
    for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for e in range(2):
            a[gid + dr, 2 * tig + dc + e] = regs[:, reg, e]
    return a


def a_index():
    """A (16 blocks x 32 values of K, both halves) as offsets into a
    staged row, found by reading a row that holds its own offsets."""
    ids = torch.arange(COLS, dtype=torch.float64)
    halves = [a_from_fragments(ldmatrix(ids, ldsm_pieces(h)))
              for h in range(2)]
    return torch.cat(halves, 1).long()


def tap_table(w):
    """The kernel's zero-padded reversed taps: table[c, x] =
    w[c, k - 1 - (x - kB3TapOff)] inside the k taps, else 0."""
    co, _, k = w.shape
    table = torch.zeros(co, TAP_COLS, dtype=w.dtype)
    table[:, TAP_OFF:TAP_OFF + k] = w[:, 0].flip(-1)
    return table


def b_fragments(table_c, s):
    """Lane (gid, tig)'s four B registers of one channel at shift s:
    register q holds j = 8 q + 2 tig, + 1 at r = gid, read at
    ``kB3TapOff + j - s - gid`` of the tap table; returns regs[lane, q,
    half]."""
    gid, tig = lanes()
    j = 8 * torch.arange(4)[None, :, None] + 2 * tig[:, None, None] \
        + torch.arange(2)
    return table_c[TAP_OFF + j - s - gid[:, None, None]]


def b_from_fragments(regs):
    """B (32 x 8) of both K-halves: register q, half e of lane (gid,
    tig) is B[8 q + 2 tig + e, gid]."""
    b = torch.zeros(32, 8, dtype=regs.dtype)
    gid, tig = lanes()
    for q in range(4):
        for e in range(2):
            b[8 * q + 2 * tig + e, gid] = regs[:, q, e]
    return b


def misalign(misalign0, e):
    return (misalign0 + e) % 8


def stage(flat, B, co, T, b, ts, c0, misalign0, tma):
    """One slot: 16 channel rows x kB3Cols values of batch row b from
    each row's 16-byte boundary before ``ts``; returns the slot and the
    rows' shifts S_c."""
    slot = torch.zeros(ROWS, COLS)
    rows = min(ROWS, co - c0)
    base = (b * co + c0 + torch.arange(rows)) * T
    shift = misalign(misalign0, base + ts)
    if tma:
        # one box of the (T, co, B) map from column ts & ~7, zeros
        # outside it (the pads, the ends, channels past co)
        assert misalign0 == 0 and T % 8 == 0
        col0 = ts & ~7
        assert (shift == ts - col0).all()
        t = col0 + torch.arange(COLS)
        inside = (t >= 0) & (t < T)
        view = flat.reshape(B, co, T)[b]
        box = torch.zeros(ROWS, COLS)
        for r in range(ROWS):       # rows c0 + r >= co stay zero
            if c0 + r < co:
                box[r, inside] = view[c0 + r, t[inside]]
        return box, shift
    # cp.async: pieces (r, q) of the rows (the lanes' order changes no
    # value); a piece inside [0, T) is one 16-byte copy from an aligned
    # element, the rest assembled with zeros
    q = torch.arange(PIECES)[None, :]
    e = base[:, None] + ts - shift[:, None] + 8 * q      # piece starts
    te = e - base[:, None]
    whole = (te >= 0) & (te + 8 <= T)
    assert (misalign(misalign0, e[whole]) == 0).all()    # aligned copies
    v = torch.arange(8)
    ev = (e[..., None] + v).clamp(0, flat.numel() - 1)
    tv = te[..., None] + v
    vals = torch.where((tv >= 0) & (tv < T), flat[ev], 0.0)
    vals = torch.where(whole[..., None], flat[ev], vals)
    slot[:rows] = vals.reshape(rows, COLS)
    return slot, shift


def grid_of(items, sms, per_sm=CTAS_PER_SM):
    """The launcher's persistent grid: SMs x CTAs per SM, at most one
    (batch row, tile) pair per warp."""
    return min(sms * per_sm, -(-items // WARPS))


def warp_loads(items, groups, grid):
    """Each warp's loads in order: (item, group), warp gw taking items
    [items gw / nw, items (gw + 1) / nw)."""
    nw = grid * WARPS
    walks = []
    for gw in range(nw):
        first, last = items * gw // nw, items * (gw + 1) // nw
        walks.append([(first + n // groups, n % groups)
                      for n in range((last - first) * groups)])
    return walks


def model_dx(g, w, pad, misalign0=0, sms=132):
    """The kernel replayed on bf16 ``g`` (B, co, T) and ``w`` (co, 1,
    k): its persistent walk, ring, staging, fragments and epilogue;
    bf16 (B, 1, T)."""
    B, co, T = g.shape
    pr = pad[1]
    tma = T % 8 == 0 and misalign0 == 0
    flat = g.float().reshape(-1)
    table = tap_table(w.float())
    ntiles = -(-T // TILE)
    groups = -(-co // ROWS)
    items = B * ntiles
    aidx = a_index()
    out = torch.zeros(B, T)
    written = torch.zeros(B, T, dtype=torch.long)
    gid, tig = lanes()
    for walk in warp_loads(items, groups, grid_of(items, sms)):
        built, frags = None, None
        ring = [None] * STAGES
        for n, (item, grp) in enumerate(walk):
            # the ring: load n sits in slot n % STAGES; load n + STAGES - 1
            # refills the slot of load n - 1, whose sums are done
            assert (n + STAGES - 1) % STAGES == (n - 1) % STAGES
            b, tile = divmod(item, ntiles)
            ts, c0 = tile * TILE - pr, grp * ROWS
            rows = min(ROWS, co - c0)
            ring[n % STAGES], shift = stage(flat, B, co, T, b, ts, c0,
                                            misalign0, tma)
            if grp == 0:
                acc = torch.zeros(4, 16, 8)
            if groups > 1 or b != built:
                # S_c of a row is the same for every tile of it
                base = (b * co + c0 + torch.arange(rows)) * T
                assert (misalign(misalign0, base - pr) == shift).all()
                frags = [b_from_fragments(b_fragments(table[c0 + c],
                                                      int(shift[c])))
                         for c in range(rows)]
                built = b
            slot = ring[n % STAGES]
            for c in range(rows):
                a = slot[c][aidx]
                for h, (j0, j1) in enumerate(((0, 16), (16, 32))):
                    acc[2 * (c % 2) + h] += a[:, j0:j1] @ frags[c][j0:j1]
            if grp == groups - 1:
                d = (acc[0] + acc[1]) + (acc[2] + acc[3])     # (16, 8)
                for half in range(2):
                    t = tile * TILE + 64 * half + 8 * gid + 2 * tig
                    for e in range(2):
                        keep = t + e < T
                        tt = (t + e)[keep]
                        out[b, tt] = d[(gid + 8 * half)[keep],
                                       (2 * tig + e)[keep]]
                        written[b, tt] += 1
    assert (written == 1).all()
    return out[:, None, :].to(BF)


def contract(g, w, pad):
    """float32 arithmetic on the bf16 operands, rounded once."""
    return ci.conv1d_ci1_dx_reference(g.float(), w.float(), pad).to(BF)


def inputs(B, co, T, k, seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((B, co, T)).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.standard_normal((co, 1, k)))
                         .astype(np.float32))
    return g.to(BF), w.to(BF)


def ulp(y) -> float:
    return 2.0 ** (math.floor(math.log2(y.abs().max().item())) - 7)


# (B, co, T, k, pad, misalign0): T = 1, 5, 8 (one tile, the pads past
# both ends), 777 and 1001 (ragged ends), 4100, 91232 at B = 1 (713
# tiles); k 2, 8, 15, 16; co 1, 16, 24 (a partial group), 64 (four
# groups); both pad sides; TMA (T % 8 == 0, aligned) and cp.async (per-row
# shifts from misalign0 1-7, or T % 8 != 0); bands inside three pieces
# (S + k <= 17, as the main path's) and wider (TMA at k 15, pad_right 4:
# S = 4), all by the same sums
CASES = [
    (2, 16, 1024, 15, (10, 4), 0),
    (3, 16, 1, 15, (7, 7), 0), (2, 1, 5, 2, (0, 1), 3),
    (2, 24, 8, 16, (15, 0), 0), (2, 64, 8, 8, (0, 7), 5),
    (2, 16, 777, 15, (14, 0), 1), (3, 24, 1001, 8, (3, 4), 6),
    (2, 16, 4100, 16, (0, 15), 2), (1, 64, 4100, 15, (7, 7), 7),
    (1, 16, 91232, 15, (7, 7), 0), (2, 1, 1024, 16, (8, 7), 0),
    (2, 16, 1024, 15, (7, 7), 4), (1, 24, 4096, 2, (1, 0), 0),
]


@pytest.mark.parametrize("B,co,T,k,pad,misalign0", CASES)
def test_model_matches_the_data_gradient(B, co, T, k, pad, misalign0):
    g, w = inputs(B, co, T, k, seed=T + co + k)
    got = model_dx(g, w, pad, misalign0).float()
    want = contract(g, w, pad).float()
    twin = ci.conv1d_ci1_dx_reference(g, w, pad).float()
    assert got.shape == (B, 1, T)
    assert (got - want).abs().max().item() <= ulp(want)
    assert (got - twin).abs().max().item() <= ulp(twin)


def test_model_matches_pallas_interpret():
    """The JAX package's ``_pallas_dx`` in interpret mode on bf16 (JAX's
    layouts: g (B, T, co), w (k, 1, co))."""
    B, co, T, pad = 2, 16, 1001, (7, 7)
    g, w = inputs(B, co, T, 15, seed=7)
    jg = jnp.asarray(g.float().numpy().transpose(0, 2, 1), jnp.bfloat16)
    jw = jnp.asarray(w.float().numpy().transpose(2, 1, 0), jnp.bfloat16)
    want = torch.from_numpy(np.asarray(
        _pallas_dx(jg, jw, pad, T, tile=256, interpret=True)
        .astype(jnp.float32))).transpose(1, 2)
    got = model_dx(g, w, pad, misalign0=3).float()
    assert (got - want).abs().max().item() <= ulp(want)


@pytest.mark.parametrize("items,groups,sms", [(1, 1, 132), (3, 4, 132),
                                              (2864, 1, 132),
                                              (11408, 1, 132), (713, 4, 3)])
def test_persistent_walk_covers_every_pair_once(items, groups, sms):
    """Every (batch row, tile) pair is loaded once per group, in group
    order, by one warp; the shares differ by at most one pair; no warp
    is idle while another holds two pairs."""
    walks = warp_loads(items, groups, grid_of(items, sms))
    seen = [load for walk in walks for load in walk]
    assert sorted(seen) == [(i, j) for i in range(items)
                            for j in range(groups)]
    sizes = [len(walk) // groups for walk in walks]
    assert max(sizes) - min(sizes) <= 1
    for walk in walks:
        assert [j for _, j in walk] == list(range(groups)) * (len(walk)
                                                               // groups)


def test_a_is_the_hankel_view():
    """A[m, j] = staged[8 m + j]: block m of K-half h reads pieces m + 2h
    and m + 2h + 1, all inside the slot's row."""
    idx = a_index()
    m, j = torch.meshgrid(torch.arange(16), torch.arange(32), indexing="ij")
    assert torch.equal(idx, 8 * m + j)
    assert idx.max().item() < COLS


@pytest.mark.parametrize("k", [1, 2, 8, 15, 16])
def test_b_fragments_are_the_banded_taps(k):
    """B[j, r] = w[k - 1 - (j - S - r)] where 0 <= j - S - r < k, else 0,
    at every shift S: the k taps of output r sit in K rows S + r ..
    S + r + k - 1, all inside the 32 of a channel."""
    w = torch.arange(1, k + 1, dtype=torch.float64).reshape(1, 1, k)
    table = tap_table(w)[0]
    for s in range(8):
        got = b_from_fragments(b_fragments(table, s))
        j, r = torch.meshgrid(torch.arange(32), torch.arange(8),
                              indexing="ij")
        o = j - s - r
        want = torch.where((o >= 0) & (o < k), w[0, 0].flip(0)[o.clamp(
            0, k - 1)], torch.zeros(()).double())
        assert torch.equal(got, want)
        assert (got != 0).sum().item() == 8 * k


def test_slots_fit_the_shared_memory_the_launcher_asks_for():
    """The rings, the tap table and the barriers fit ``kB3Smem`` with the
    128-byte alignment slack, ``kB3CtasPerSm`` CTAs fit an SM, a slot is a whole
    number of 128-byte units (TMA destinations), and the launcher raises
    the limit to, and launches with, ``kB3Smem``."""
    need = (127 + WARPS * STAGES * C["kB3SlotBytes"]
            + C["kMaxCo"] * TAP_COLS * 2 + WARPS * STAGES * 8)
    assert need <= C["kB3Smem"]
    assert C["kB3SlotBytes"] == ROWS * COLS * 2
    assert C["kB3SlotBytes"] % 128 == 0
    assert CTAS_PER_SM * (C["kB3Smem"] + CTA_RESERVED) <= SM_BYTES
    assert "max_smem_once<ci1_dx_bf16_mma_kernel<kTma>>(kB3Smem)" in SOURCE
    assert "<<<grid, kB3Threads, kB3Smem, stream>>>" in SOURCE
    # the window of the last block at the largest shift and k, and the
    # last piece A reads
    assert 7 + TILE - 1 + 16 - 1 < COLS
    assert a_index().max().item() == COLS - 1


def test_ldmatrix_rows_are_conflict_free():
    """Every 8 x 8 matrix an ``ldmatrix.x4`` reads (channel row c, K-half
    h) is 8 consecutive 16-byte pieces of one staged row: 8 distinct
    groups of 4 banks."""
    for c in range(ROWS):
        for h in range(2):
            addr = c * COLS * 2 + 16 * ldsm_pieces(h)
            for mat in range(4):
                group = (addr[8 * mat:8 * mat + 8] % 128) // 16
                assert sorted(group.tolist()) == list(range(8))
