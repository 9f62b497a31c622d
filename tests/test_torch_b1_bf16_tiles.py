"""A model of kernel B1-bf16's staging, held against the unit on the CPU.

The kernel (``rave_tpu_torch/csrc/residual_unit.cu``,
``residual_unit_bf16_wgmma_kernel``) cannot run here, but its index
arithmetic can: this file replays it with torch on bf16 values.  Each
CTA of a cluster (``C / 64`` CTAs sharing a 64-step time tile) stages,
tap by tap, TMA windows of x of 72 steps from ``t0 - pad_left + j * d``
rounded down to 8 (TMA starts a row on a 16-byte boundary; zeros
outside the tensor) and W1 tiles of ``w1k`` ``(k * C, C)`` laid out with
TMA's 128-byte swizzle; reads x as wgmma's register operand A with
``ldmatrix.trans`` of the aligned 8-step blocks, moved across lanes by
the tap's shift, and lrelu in bf16 (the two warpgroups each take two
of a slot's four k16 steps: the model sums all four); writes its hidden
tile (rounded once) into its block of the hidden buffer and pushes it to
every peer; reads the whole buffer back as A of GEMM 2 with
``ldmatrix``; and stores ``bf16(x + (acc + b2))`` through the residual
tile.  The wrapper's time padding (``pad_time``) is replayed too.

The model must agree with the bf16 contract computed directly (float32
arithmetic, the hidden tile and the output each rounded once) within 1
ulp of max |y| (the sums run in another order), and with the plain twin
``residual_unit_reference`` within ``chip_smoke.B1_BF16_ULPS`` (2 ulps),
as the kernel must on the card.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rave_tpu_torch.ops.kernels import residual_unit as ru

BT = BC = 64              # time steps and channels of a tile
XW = BT + 8               # steps of an x window
SLOPE = 0.2001953125      # 0.2 rounded to bf16
BF = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf(v):
    """Round float32 values to bf16 (kept as float32)."""
    return v.to(BF).float()


def sw128(row, col):
    """Byte offset of (row, col) in a 64 x 64 bf16 tile as TMA's 128-byte
    swizzle lays it out (the kernel's ``sw128``)."""
    return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2


def tma_box(src, col0, row0, rows, cols=64):
    """A TMA box of ``rows`` x ``cols`` at (col0, row0) of a 2-D tensor:
    zeros where it leaves the tensor."""
    assert col0 % 8 == 0    # a row starts on a 16-byte boundary
    box = torch.zeros(rows, cols)
    r0, r1 = max(row0, 0), min(row0 + rows, src.shape[0])
    c0, c1 = max(col0, 0), min(col0 + cols, src.shape[1])
    if r0 < r1 and c0 < c1:
        box[r0 - row0:r1 - row0, c0 - col0:c1 - col0] = src[r0:r1, c0:c1]
    return box


def write_box(tile, box, byte0=0):
    """Write a box into a tile (4096 values) as TMA does: row r, column c
    at ``byte0 + sw128(r, c)``."""
    r, c = torch.meshgrid(torch.arange(box.shape[0]), torch.arange(64),
                          indexing="ij")
    tile[(byte0 + sw128(r, c)) // 2] = box


def ldmatrix(tile, addrs, trans, n=4):
    """``ldmatrix.x{n}`` (``.trans``): lane l < 8 n gives the row address
    of row l % 8 of matrix l // 8 (16-byte aligned); returns regs[lane,
    matrix, half]."""
    assert (addrs[:8 * n] % 16 == 0).all()
    rows = tile[(addrs[:8 * n, None] + 2 * torch.arange(8)) // 2]
    m = rows.reshape(n, 8, 8)                   # [matrix][row][column]
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    i = torch.arange(n)[None, :]
    if trans:
        lo, hi = m[i, 2 * t[:, None], g[:, None]], m[i, 2 * t[:, None] + 1,
                                                      g[:, None]]
    else:
        lo, hi = m[i, g[:, None], 2 * t[:, None]], m[i, g[:, None],
                                                     2 * t[:, None] + 1]
    return torch.stack([lo, hi], -1)            # (32, 4, 2)


def a_matrix(regs_per_warp):
    """wgmma's register operand A (64 x 16) from the four warps' fragments:
    warp w, lane (g, t): reg 0 rows 16 w + g, columns 2 t, 2 t + 1; reg 1
    rows + 8; reg 2 columns + 8; reg 3 both."""
    a = torch.zeros(64, 16, dtype=regs_per_warp[0].dtype)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for w, regs in enumerate(regs_per_warp):
        for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            for h in range(2):
                a[16 * w + g + dr, 2 * t + dc + h] = regs[:, reg, h]
    return a


def b_matrix(tile, kk):
    """B (16 x 64) of a wgmma whose descriptor points 32 * kk bytes into a
    K-major 128B-swizzled tile: B[k][n] is row n, column 16 kk + k."""
    k, n = torch.meshgrid(torch.arange(16), torch.arange(64), indexing="ij")
    return tile[sw128(n, 16 * kk + k) // 2]


def lrelu_bf16(v):
    """max(v, bf16(0.2001953125 v)): the kernel's packed bf16 lrelu."""
    return torch.maximum(v, bf(v * SLOPE))


def ldsm_lanes():
    lane = torch.arange(32)
    return lane >> 3, lane & 7                  # matrix, row


def x_addrs(w, kk):
    """The byte offsets in an x window (rows of XW steps) that the lanes
    of warp w give ``ldmatrix.x4.trans`` (channel rows 16 kk + 8 (mi / 2)
    + r at the aligned blocks 16 w + 8 (mi % 2)) and ``.x2.trans``
    (lanes 0-15: channel rows 16 kk + 8 (mi % 2) + r at block 16 w +
    16)."""
    mi, r = ldsm_lanes()
    rows = (16 * kk + r) * (XW * 2) + 32 * w
    return (rows + 8 * (mi >> 1) * (XW * 2) + 16 * (mi & 1),
            rows + 8 * (mi & 1) * (XW * 2) + 32)


def load_a_x(window, w, kk, shift):
    """The kernel's ``load_a_x`` for one warp: the aligned blocks by
    ldmatrix (the third only where the shift is not 0), then lane (g, t)
    takes step g + shift from lane 4 ((g + shift) % 8) + t of the block
    that holds it (``__shfl_sync``)."""
    a4, a2 = x_addrs(w, kk)
    a = ldmatrix(window, a4, trans=True)
    if shift == 0:
        return a
    e = ldmatrix(window, a2, trans=True, n=2)
    lane = torch.arange(32)
    q = (lane >> 2) + shift
    src = ((q & 7) << 2) | (lane & 3)
    hi = torch.stack([a[:, 1], e[:, 0], a[:, 3], e[:, 1]], 1)
    return torch.where((q < 8)[:, None, None], a[src], hi[src])


def a_index_x(shift):
    """For each k16 step kk, the window offsets (in values) of wgmma's A
    (64 steps x 16 channels) as :func:`load_a_x` reads them, found by
    reading a window that holds its own offsets."""
    ids = torch.arange(BC * XW, dtype=torch.float64)
    return [a_matrix([load_a_x(ids, w, kk, shift) for w in range(4)]).long()
            for kk in range(4)]


def h_addrs(w, kk):
    """The byte offsets in a hidden tile that the lanes of warp w give
    ``ldmatrix.x4`` (rows = steps 16 w + 8 (mi % 2) + r, channels 16 kk
    + 8 (mi / 2))."""
    mi, r = ldsm_lanes()
    return sw128(16 * w + 8 * (mi & 1) + r, 16 * kk + 8 * (mi >> 1))


def a_index_h():
    """For each k16 step kk, the hidden tile's offsets of A (64 steps x
    16 channels) as the warps' ``ldmatrix.x4`` read them."""
    ids = torch.arange(BT * BC, dtype=torch.float64)
    return [a_matrix([ldmatrix(ids, h_addrs(w, kk), False)
                      for w in range(4)]).long() for kk in range(4)]


def d_index():
    """The hidden tile's offsets (in values) of the accumulator's D[t][c]
    as the kernel writes them: warp w, lane (g, t), block i, half h,
    element e at ``sw128(16 w + g + 8 h, 8 i + 2 t) + 2 e``."""
    idx = torch.zeros(BT, BC, dtype=torch.long)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for w in range(4):
        for i in range(8):
            for h in range(2):
                for e in range(2):
                    row, col = 16 * w + g + 8 * h, 8 * i + 2 * t
                    idx[row, col + e] = (sw128(row, col) + 2 * e) // 2
    return idx


def stage_x(x2d, t, row0):
    """One ring slot's x window (64 rows of XW steps, row-major, no
    swizzle) from step ``t`` rounded down to 8; returns the window and
    the tap's shift into it."""
    t_al = t & ~7                                # the kernel's rounding
    return tma_box(x2d, t_al, row0, BC, XW).flatten(), t - t_al


def model_unit(x, w1, b1, w2, b2, d, pl):
    """The kernel's staging replayed on bf16 tensors ``x`` (B, C, T),
    ``w1`` (C, C, k), ``w2`` (C, C), ``b1``, ``b2`` (C,); bf16 out."""
    T = x.shape[-1]
    xp, pad = ru.pad_time(x)
    B, C, Tl = xp.shape
    k = w1.shape[-1]
    assert Tl % 8 == 0 and pad == -T % 8
    w1k, w2k = ru.prepare_weights(w1, w2)
    x2d = xp.float().reshape(B * C, Tl)
    w1_2d = w1k.float().reshape(k * C, C)
    w2_2d = w2k.float()
    b1f, b2f = b1.float(), b2.float()
    out2d = torch.zeros(B * C, Tl)
    nblk = C // BC
    ax = [a_index_x(shift) for shift in range(8)]
    ah, hd = a_index_h(), d_index()
    kn = torch.meshgrid(torch.arange(16), torch.arange(64), indexing="ij")
    bx = [sw128(kn[1], 16 * kk + kn[0]) // 2 for kk in range(4)]
    ct = torch.meshgrid(torch.arange(BC), torch.arange(BT), indexing="ij")
    at = sw128(*ct) // 2                        # residual tile, rows = c

    def weight_tile(src, col0, row0):
        tile = torch.zeros(BT * BC)
        write_box(tile, tma_box(src, col0, row0, BC))
        return tile

    for b in range(B):
        row0 = b * C
        for t0 in range(0, Tl, BT):
            # GEMM 1's slots u = (block cb of input channels, tap j): the
            # x boxes are the same for every CTA of the cluster
            xs = [stage_x(x2d, t0 - pl + (u % k) * d, row0 + (u // k) * BC)
                  for u in range(nblk * k)]
            hidden = []                         # CTA p's hidden tile
            for rank in range(nblk):
                co0 = rank * BC
                acc = torch.zeros(BT, BC)
                for u, (xt, shift) in enumerate(xs):
                    cb, j = divmod(u, k)
                    assert shift == (j * d - pl) & 7   # the kernel's shift
                    ws = weight_tile(w1_2d, cb * BC, j * C + co0)
                    for kk in range(4):
                        acc += lrelu_bf16(xt[ax[shift][kk]]) @ ws[bx[kk]]
                v = acc + b1f[co0:co0 + BC]
                tile = torch.zeros(BT * BC)
                tile[hd] = bf(torch.where(v >= 0, v, 0.2 * v))
                hidden.append(tile)
            # the push: block p of every CTA's hidden buffer is CTA p's
            for rank in range(nblk):
                buffer = list(hidden)
                co0 = rank * BC
                acc = torch.zeros(BT, BC)
                for v in range(nblk):           # GEMM 2's slots
                    ws = weight_tile(w2_2d, v * BC, co0)
                    for kk in range(4):
                        acc += buffer[v][ah[kk]] @ ws[bx[kk]]
                # out = bf16(x + (acc + b2)) over the residual tile (rows =
                # channels), then the TMA store, clipped at the edge
                xres = torch.zeros(BT * BC)
                write_box(xres, tma_box(x2d, t0, row0 + co0, BC))
                xres[at] = bf(xres[at] + (acc.T + b2f[co0:co0 + BC, None]))
                n = min(BT, Tl - t0)
                out2d[row0 + co0:row0 + co0 + BC, t0:t0 + n] = \
                    xres[at][:, :n]
    return out2d.reshape(B, C, Tl)[..., :T].to(BF)


def contract(x, w1, b1, w2, b2, d, pl, pr):
    """The bf16 contract in float32 arithmetic (chip_smoke.py's
    ``b1_bf16_contract``): lrelu(x) in bf16, GEMM 1, + b1 and lrelu in
    float32, the hidden tile rounded once, GEMM 2, + b2 and + x in
    float32, rounded once."""
    h = F.pad(lrelu_bf16(x.float()), (pl, pr))
    h = F.leaky_relu(F.conv1d(h, w1.float(), b1.float(), dilation=d), 0.2)
    y = F.conv1d(bf(h), w2.float()[:, :, None], b2.float())
    return (y + x.float()).to(BF)


def inputs(B, C, T, k, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return [a.to(BF) for a in (r(B, C, T), r(C, C, k) / math.sqrt(C * k),
                               r(C) * 0.1, r(C, C) / math.sqrt(C),
                               r(C) * 0.1)]


def ulp(y) -> float:
    return 2.0 ** (math.floor(math.log2(y.abs().max().item())) - 7)


# the grid's edge cases: T = 1 and 333 (padded to 8), d = 1000 (every
# tap but one outside the tensor), C = 384 (clusters of 6), k = 1 and 5,
# two batch rows, several time tiles
CASES = [(1, 128, 333, 3, 1000), (2, 384, 333, 5, 3), (1, 256, 1, 1, 1),
         (1, 128, 200, 5, 9), (1, 512, 64, 1, 3)]


@pytest.mark.parametrize("B,C,T,k,d", CASES)
def test_model_matches_the_unit(B, C, T, k, d):
    args = inputs(B, C, T, k, seed=C + T + d)
    p = (k - 1) * d
    pl, pr = (p + 1) // 2, p // 2
    got = model_unit(*args, d, pl).float()
    want = contract(*args, d, pl, pr).float()
    twin = ru.residual_unit_reference(*args, d, pl, pr).float()
    assert got.shape == (B, C, T)
    assert (got - want).abs().max().item() <= ulp(want)
    assert (got - twin).abs().max().item() <= 2.0 * ulp(twin)


def test_swizzle_is_a_permutation_and_ldmatrix_conflict_free():
    """sw128 permutes the tile's 16-byte pieces within each row, and the
    8 rows of every matrix an ldmatrix reads (x windows, rows of 144
    bytes; hidden tiles, 128B-swizzled) fall in 8 distinct groups of 4
    banks."""
    r, c = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    offs = sw128(r, c)
    assert sorted(offs.flatten().tolist()) == list(range(0, 8192, 2))
    assert ((offs // 128) == r).all()
    for w in range(4):
        for kk in range(4):
            a4, a2 = x_addrs(w, kk)
            for addr, n in ((a4, 4), (a2, 2), (h_addrs(w, kk), 4)):
                for i in range(n):
                    group = (addr[8 * i:8 * i + 8] % 128) // 16
                    assert sorted(group.tolist()) == list(range(8))


@pytest.mark.parametrize("T", [1, 7, 8, 333, 512])
def test_pad_time_keeps_the_first_outputs(T):
    """The wrapper pads T to a multiple of 8 with zeros for TMA's 16-byte
    strides: the twin on the padded x, sliced, equals the twin on x."""
    x, w1, b1, w2, b2 = inputs(2, 128, T, 3, seed=T)
    xp, pad = ru.pad_time(x)
    assert pad == -T % 8 and xp.shape[-1] == T + pad
    assert xp.data_ptr() % 16 == 0 and torch.equal(xp[..., :T], x)
    for d in (1, 9):
        want = ru.residual_unit_reference(x, w1, b1, w2, b2, d, d, d)
        got = ru.residual_unit_reference(xp, w1, b1, w2, b2, d, d, d)
        assert torch.equal(got[..., :T], want)
    x32 = x.float()
    assert ru.pad_time(x32)[0] is x32 and ru.pad_time(x32)[1] == 0


def region_a():
    """Region A's size and the partial sums' offset in it, read from the
    kernel's source (``kStages1`` slots of an x window and a W1 tile;
    ``kPartOffset`` in hidden tiles), and a check that ``part`` uses it."""
    src = (Path(ru.__file__).resolve().parents[2] / "csrc"
           / "residual_unit.cu").read_text()
    stages = int(re.search(r"constexpr int kStages1 = (\d+);", src)[1])
    tiles = int(re.search(r"constexpr int kPartOffset = (\d+) \* "
                          r"kTileBytes;", src)[1])
    assert "part = ring1 + kPartOffset + 4 * (tid & 127);" in src
    return stages * (BC * XW * 2 + 2 * BT * BC), tiles * 2 * BT * BC


def clashes(part0, C):
    """(rank, warp, e) where warp ``warp`` of warpgroup 0 of the CTA of
    rank ``rank`` writes its hidden rows (16 w + gid + 8 h, columns 8 i +
    2 tig, +1) over partial sum e of some thread (``part0 + 4 t + 512
    e``), or a peer's push (every other hidden tile) lands on one: either
    may overtake warpgroup 0's reads of the sums, as nothing orders them
    within the warpgroup."""
    nblk = C // BC
    t, e = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    owner = np.full(BT * BC * 2 * nblk + 32 * 128 * 4 + part0, -1)
    for b in range(4):
        owner[part0 + 4 * t + 512 * e + b] = e
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    found = set()
    for rank in range(nblk):
        for w in range(4):
            for i in range(8):
                for h in range(2):
                    byte = rank * 2 * BT * BC + sw128(
                        16 * w + gid + 8 * h, 8 * i + 2 * tig)
                    for b in range(4):
                        found |= {(rank, w, int(v))
                                  for v in owner[byte + b] if v >= 0}
        peers = [p for p in range(nblk) if p != rank]
        for p in peers:
            hit = owner[p * 2 * BT * BC:(p + 1) * 2 * BT * BC]
            found |= {(rank, "push", int(v)) for v in hit[hit >= 0]}
    return sorted(found, key=str)


@pytest.mark.parametrize("C", [128, 256, 384, 512])
def test_partial_sums_clear_of_the_hidden_buffer(C):
    """The warpgroups' partial sums and the hidden buffer share region A:
    the sums must lie past every CTA's hidden tile (its own, written by
    warpgroup 0 right after its reads of the sums, and those its peers
    push), and inside the region.  The sums at the region's start would
    clash (the check can see it)."""
    size, part0 = region_a()
    assert part0 >= (C // BC) * 2 * BT * BC
    assert part0 + 32 * 128 * 4 <= size
    assert clashes(part0, C) == []
    assert (0, 0, 0) in clashes(0, C)
