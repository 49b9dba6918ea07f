"""Corpus-scale CLI: encode, decode, or transcode whole directories with
the batch drivers (resume + per-file error isolation; optional device
batching; multi-host aware for encode).

Usage:
  python -m tpudraco.tools.corpus encode    -i meshes/ -o out/ [--device]
  python -m tpudraco.tools.corpus decode    -i drcs/   -o out/ [--fmt ply]
  python -m tpudraco.tools.corpus transcode -i glbs/   -o out/ [--host-only]

Inputs may be directories (scanned non-recursively for known extensions)
or explicit file lists. Under a multi-host launcher
(JAX_COORDINATOR_ADDRESS set), `encode` shards the corpus across hosts
(parallel/multihost.py).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ENCODE_EXTS = (".obj", ".ply", ".gltf", ".glb")
DECODE_EXTS = (".drc",)
TRANSCODE_EXTS = (".gltf", ".glb")


def _expand(inputs: list[str], exts) -> list[str]:
    out = []
    for p in inputs:
        if os.path.isdir(p):
            for e in exts:
                out.extend(sorted(glob.glob(os.path.join(p, "*" + e))))
        else:
            out.append(p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpudraco-corpus")
    ap.add_argument("command", choices=("encode", "decode", "transcode"))
    ap.add_argument("-i", "--input", nargs="+", required=True,
                    help="input files or directories")
    ap.add_argument("-o", "--output", required=True, help="output directory")
    ap.add_argument("--device", action="store_true",
                    help="encode/decode: batch same-topology work on the "
                         "accelerator (device compute + rANS lanes)")
    ap.add_argument("--route", choices=("manual", "auto"), default="manual",
                    help="encode with --device: 'auto' measures host vs "
                         "device per topology group in-process and routes "
                         "each group to the faster plane (decisions in "
                         "the corpus report)")
    ap.add_argument("--host-only", action="store_true",
                    help="transcode: skip the device batch")
    ap.add_argument("--no-resume", action="store_true",
                    help="re-process inputs whose outputs already exist")
    ap.add_argument("--workers", type=int, default=1,
                    help="host thread workers (encode/decode)")
    ap.add_argument("--window", type=int, default=None,
                    help="encode --device: meshes resident at once "
                         "(bounded host RAM; default 256)")
    ap.add_argument("--fmt", default="obj", choices=("obj", "ply"),
                    help="decode output format")
    ap.add_argument("--khr-ids", choices=("unique", "reference"),
                    default="unique",
                    help="transcode: KHR attribute-id mapping (see the "
                         "single-file CLI)")
    ap.add_argument("-cl", "--compression-level", type=int, default=None,
                    choices=range(0, 11), metavar="N",
                    help="transcode: compression preset for every "
                         "primitive (routes primitives to the host "
                         "encoder; -qp/-qt/-qn alone stay on device)")
    ap.add_argument("-qp", type=int, default=None, metavar="BITS",
                    help="position quantization bits (encode + transcode)")
    ap.add_argument("-qt", type=int, default=None, metavar="BITS",
                    help="texcoord quantization bits (encode + transcode)")
    ap.add_argument("-qn", type=int, default=None, metavar="BITS",
                    help="normal octahedral bits, 7..16 "
                         "(encode + transcode)")
    ap.add_argument("-qg", type=int, default=None, metavar="BITS",
                    help="generic float attribute bits "
                         "(COLOR/TANGENT/WEIGHT; encode + transcode)")
    args = ap.parse_args(argv)
    resume = not args.no_resume
    if args.device or (args.command == "transcode" and not args.host_only):
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache()

    cfg = None
    if any(v is not None for v in (args.qp, args.qt, args.qn, args.qg,
                                   args.compression_level)):
        from ..encode import Config
        from ..models import AttributeType
        cfg = (Config.from_level(args.compression_level)
               if args.compression_level is not None else Config())
        if args.qp is not None:
            cfg.quant_bits[AttributeType.POSITION] = args.qp
        if args.qt is not None:
            cfg.quant_bits[AttributeType.TEX_COORD] = args.qt
        if args.qn is not None:
            cfg.quant_bits[AttributeType.NORMAL] = args.qn
        if args.qg is not None:
            for t in (AttributeType.COLOR, AttributeType.TANGENT,
                      AttributeType.WEIGHT):
                cfg.quant_bits[t] = args.qg

    if args.command == "encode":
        inputs = _expand(args.input, ENCODE_EXTS)
        if os.environ.get("JAX_COORDINATOR_ADDRESS"):
            from ..parallel import encode_corpus_multihost, init_distributed
            init_distributed()
            report = encode_corpus_multihost(inputs, args.output,
                                             resume=resume,
                                             use_device=args.device,
                                             workers=args.workers, cfg=cfg)
        else:
            from ..parallel import BatchEncoder
            use_device = ("auto" if (args.device and args.route == "auto")
                          else args.device)
            report = BatchEncoder(use_device=use_device,
                                  cfg=cfg).encode_corpus(
                inputs, args.output, resume=resume, workers=args.workers,
                device_window=args.window)
    elif args.command == "decode":
        from ..parallel import BatchDecoder
        inputs = _expand(args.input, DECODE_EXTS)
        report = BatchDecoder().decode_corpus(
            inputs, args.output, resume=resume, fmt=args.fmt,
            workers=args.workers, use_device=args.device)
    else:
        from ..parallel import transcode_corpus
        inputs = _expand(args.input, TRANSCODE_EXTS)
        report = transcode_corpus(inputs, args.output,
                                  use_device=not args.host_only,
                                  resume=resume, khr_ids=args.khr_ids,
                                  cfg=cfg)

    json.dump(report, sys.stdout, indent=1)
    sys.stdout.write("\n")
    return 0 if not report.get("failed") else 1


if __name__ == "__main__":
    raise SystemExit(main())
