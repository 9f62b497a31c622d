"""``python -m rave_tpu_torch.cli``: the port's console dispatcher.

Every subcommand of the JAX package's ``rave-tpu`` (``rave_tpu/cli.py``),
with its flags: ``preprocess``, ``perturb``, ``units``, ``decode_noise``,
``speaker_stats``, ``train``, ``export``, ``eval``, ``validate_assets``
and ``remote_dataset``.  The commands that run a network (``train``,
``export``, ``eval``, and ``speaker_stats`` and ``validate_assets`` where
they load a checkpoint) add ``--device`` (default ``cuda``, which raises
without CUDA).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from pathlib import Path

# subcommand -> the ROADMAP item that ports it: none is left
NOT_PORTED: dict[str, str] = {}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rave_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    pp = sub.add_parser("preprocess", help="build a dataset from audio files")
    pp.add_argument("--input_path", required=True)
    pp.add_argument("--output_path", required=True)
    pp.add_argument("--num_signal", type=int, default=131072)
    pp.add_argument("--sampling_rate", type=int, default=44100)
    pp.add_argument("--num_workers", type=int, default=8)
    pp.add_argument("--lazy", action="store_true",
                    help="store only {path, length}; items decode on "
                         "demand (reference preprocess --lazy)")
    pp.add_argument("--perturb_variants", type=int, default=0,
                    help="precompute N perturbed views per record (EQ + "
                         "formant/pitch shift); also the `perturb` command")

    pv = sub.add_parser("perturb", help="precompute perturbation variants "
                                        "for an existing dataset")
    pv.add_argument("--db_path", required=True)
    pv.add_argument("--variants", type=int, default=8)
    pv.add_argument("--num_workers", type=int, default=0,
                    help="0 = all cores")

    tr = sub.add_parser("train", help="train a model")
    tr.add_argument("--config", action="append", default=[],
                    help="config preset(s), composed in order")
    tr.add_argument("--override", action="append", default=[],
                    help="key=value config overrides")
    tr.add_argument("--db_path", required=True)
    tr.add_argument("--name", default="run")
    tr.add_argument("--out_path", default="runs")
    tr.add_argument("--max_steps", type=int, default=None)
    tr.add_argument("--val_every", type=int, default=10000)
    tr.add_argument("--ckpt_every", type=int, default=10000)
    tr.add_argument("--batch", type=int, default=None)
    tr.add_argument("--ema", type=float, default=None)
    tr.add_argument("--resume", action="store_true")
    tr.add_argument("--num_workers", type=int, default=0,
                    help="loader worker processes (reference uses 8)")
    tr.add_argument("--multihost", action="store_true",
                    help="data parallelism over the ranks torchrun starts, "
                         "one per device (NCCL; gloo with --device cpu)")
    tr.add_argument("--normalize", action="store_true",
                    help="peak-normalise items")
    tr.add_argument("--derivative", action="store_true",
                    help="train on the signal derivative; demos are "
                         "integrated back")
    tr.add_argument("--speaker_stats", default=None,
                    help="per-speaker f0 stats json (from `speaker_stats`) "
                         "for pitch conditioning; default "
                         "<db_path>/speaker_stats.json")
    prt = tr.add_mutually_exclusive_group()
    prt.add_argument("--perturb", action="store_true", default=None,
                     help="perturb the encoder input (formant/pitch shift "
                          "+ EQ); default follows the config")
    prt.add_argument("--no_perturb", dest="perturb", action="store_false",
                     help="disable input perturbation even if the config "
                          "enables it")
    tr.add_argument("--noise_path", default=None,
                    help="pre-decoded noise corpus dir (`decode_noise`) "
                         "mixed into the perturbed view at 14-15 dB SNR")
    tr.add_argument("--profile", action="store_true",
                    help="section times (load, put, step, sync) and a "
                         "torch.profiler trace of steps 10-15 under "
                         "<run>/profile")
    tr.add_argument("--speaker_ckpt", default=None,
                    help="pretrained torch speaker-encoder checkpoint "
                         "(VoxCeleb ECAPA, __S__.-prefixed keys); without "
                         "it use --override train_speaker_encoder=true")
    tr.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the kernels' plain "
                         "versions")

    ex = sub.add_parser("export", help="export a streaming model")
    ex.add_argument("--run", required=True)
    ex.add_argument("--streaming", action="store_true", default=True)
    ex.add_argument("--chunk_size", type=int, default=2048)
    ex.add_argument("--stereo", action="store_true",
                    help="fake stereo: one encoding, dual decoding")
    ex.add_argument("--target_sr", type=int, default=None,
                    help="host sample rate (integer multiple of the "
                         "model rate); adds streaming resampler stages")
    ex.add_argument("--best", action="store_true",
                    help="export the best-validation checkpoint instead "
                         "of the latest")
    ex.add_argument("--voice_conversion", action="store_true",
                    help="also export the conversion step "
                         "(speaker-conditioned models)")
    ex.add_argument("--speaker_wavs", nargs="*", default=[],
                    help="target-speaker wavs whose embeddings become the "
                         "exported speaker table")
    ex.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                    default=None,
                    help="dtype of the encoder and decoder in the exported "
                         "steps (default: the run's)")
    ex.add_argument("--device", default="cuda",
                    help="torch device the programs are exported on")

    ev = sub.add_parser("eval", help="speaker-embedding t-SNE evaluation")
    ev.add_argument("--run", required=True)
    ev.add_argument("--db_path", required=True)
    ev.add_argument("--max_items", type=int, default=512)
    ev.add_argument("--device", default="cuda", help="torch device")

    un = sub.add_parser("units", help="precompute discrete-unit CE targets")
    un.add_argument("--db_path", required=True)
    un.add_argument("--num_units", type=int, default=100)
    un.add_argument("--provider", choices=["mel", "hubert"],
                    default=("hubert"
                             if os.environ.get("RAVE_TPU_HUBERT_CKPT")
                             else "mel"),
                    help="mel: log-mel k-means; hubert: features from a "
                         "local HuBERT checkpoint (default when "
                         "$RAVE_TPU_HUBERT_CKPT is set)")
    un.add_argument("--ckpt", default=os.environ.get("RAVE_TPU_HUBERT_CKPT"),
                    help="hubert provider: transformers HubertModel dir or "
                         "TorchScript feature extractor")
    un.add_argument("--layer", type=int, default=7,
                    help="hubert provider: transformer layer to quantize")

    dn = sub.add_parser("decode_noise", help="pre-decode a noise corpus")
    dn.add_argument("--input_path", required=True)
    dn.add_argument("--output_path", required=True)
    dn.add_argument("--sampling_rate", type=int, default=44100)

    st = sub.add_parser("speaker_stats", help="per-speaker f0 statistics")
    st.add_argument("--db_path", required=True)
    st.add_argument("--pitch_ckpt",
                    default=os.environ.get("RAVE_TPU_FCPE_CKPT", ""),
                    help="torchfcpe checkpoint: f0 by the FCPE network; "
                         "defaults to $RAVE_TPU_FCPE_CKPT, else YIN")
    st.add_argument("--out", default=None,
                    help="output json; default <db_path>/"
                         "speaker_stats.json (where train looks)")
    st.add_argument("--device", default="cuda",
                    help="torch device of the FCPE network")

    va = sub.add_parser(
        "validate_assets",
        help="validate the frozen-teacher assets (FCPE / HuBERT / speaker "
             "checkpoints) against the port's readers and write a report")
    va.add_argument("--fcpe_ckpt", default=None,
                    help="torchfcpe checkpoint (default $RAVE_TPU_FCPE_CKPT)")
    va.add_argument("--hubert_ckpt", default=None,
                    help="local HuBERT checkpoint dir or TorchScript file "
                         "(default $RAVE_TPU_HUBERT_CKPT)")
    va.add_argument("--speaker_ckpt", default=None,
                    help="VoxCeleb ECAPA speaker checkpoint (__S__. layout)")
    va.add_argument("--db_path", default=None,
                    help="preprocessed dataset for the mel-vs-HuBERT "
                         "unit-stats comparison")
    va.add_argument("--out", default=None,
                    help="report path (default docs/assets_validation.md)")
    va.add_argument("--device", default="cuda",
                    help="torch device of the FCPE and speaker checks")

    rd = sub.add_parser("remote_dataset",
                        help="serve a preprocessed dataset over HTTP")
    rd.add_argument("--db_path", required=True)
    rd.add_argument("--host", default="0.0.0.0")
    rd.add_argument("--port", type=int, default=8080)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(
        argv if argv is not None else sys.argv[1:])

    if args.command == "preprocess":
        from .data.dataset import precompute_perturbed, preprocess
        if args.perturb_variants and args.lazy:
            raise SystemExit("--perturb_variants needs a record-store db "
                             "(drop --lazy)")
        print(preprocess(args.input_path, args.output_path,
                         n_signal=args.num_signal,
                         sample_rate=args.sampling_rate,
                         num_workers=args.num_workers, lazy=args.lazy))
        if args.perturb_variants:
            path = precompute_perturbed(args.output_path,
                                        args.perturb_variants,
                                        num_workers=args.num_workers)
            print(f"wrote {args.perturb_variants} perturbed variants/record "
                  f"to {path}")
    elif args.command == "perturb":
        from .data.dataset import precompute_perturbed
        path = precompute_perturbed(args.db_path, args.variants,
                                    num_workers=args.num_workers)
        print(f"wrote {args.variants} perturbed variants/record to {path}")
    elif args.command == "train":
        from .train.trainer import train_main
        train_main(args)
    elif args.command == "export":
        from .export.streaming import export_main
        export_main(args)
    elif args.command == "eval":
        from .train.eval_viz import eval_main
        eval_main(args)
    elif args.command == "units":
        from .data.dataset import AudioDataset
        from .data.units import (MelKMeansUnitProvider,
                                 TorchHubertUnitProvider, precompute_units,
                                 unit_stats)
        ds = AudioDataset(args.db_path)
        if args.provider == "hubert":
            if not args.ckpt:
                raise SystemExit("--provider hubert needs --ckpt (a local "
                                 "HuBERT checkpoint)")
            prov = TorchHubertUnitProvider(args.ckpt, sr=ds.sr,
                                           layer=args.layer,
                                           num_units=args.num_units)
            if prov.codebook is None:
                prov.fit(ds)
        else:
            prov = MelKMeansUnitProvider(num_units=args.num_units,
                                         sr=ds.sr).fit(ds)
        prov.save(str(Path(args.db_path) / "unit_codebook.npy"))
        arr = precompute_units(ds, prov, args.db_path)
        print(f"wrote units {arr.shape} to {args.db_path}/units.npy "
              f"({args.provider})")
        print("unit stats: " + json.dumps(unit_stats(arr, args.num_units)))
    elif args.command == "decode_noise":
        from .data.noise_corpus import decode_noise_corpus
        res = decode_noise_corpus(args.input_path, args.output_path,
                                  args.sampling_rate)
        print(f"decoded {len(res)} noise files")
    elif args.command == "speaker_stats":
        from .data.dataset import AudioDataset
        from .data.pitch import compute_speaker_stats
        out = args.out or str(Path(args.db_path) / "speaker_stats.json")
        stats = compute_speaker_stats(AudioDataset(args.db_path), out,
                                      pitch_ckpt=args.pitch_ckpt,
                                      device=args.device)
        print(json.dumps(stats, indent=2))
    elif args.command == "validate_assets":
        from .utils.assets import validate_assets_main
        validate_assets_main(args)
    elif args.command == "remote_dataset":
        from .data.dataset import AudioDataset
        from .data.remote import serve_dataset
        ds = AudioDataset(args.db_path)
        server = serve_dataset(ds, host=args.host, port=args.port)
        print(f"serving {len(ds)} items on {args.host}:{args.port} "
              "(ctrl-c to stop)", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()


if __name__ == "__main__":
    main()
