"""Command-line interface: OBJ/glTF encode, decode, and transcode.

Mirrors the reference CLI (cli/src/main.rs: `-i x.obj -o y.drc` and
`--transcode -i x.glb -o y.glb`), plus decode (`-i x.drc -o y.obj`) which
the reference cannot do (its decoder is disabled).

Usage:
  python -m tpudraco.tools.cli -i mesh.obj -o mesh.drc
  python -m tpudraco.tools.cli -i mesh.drc -o mesh.obj
  python -m tpudraco.tools.cli --transcode -i scene.glb -o scene_draco.glb
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _build_config(args):
    """Encoder Config from the CLI flags (shared by the .drc and
    --transcode paths; explicit flags override -cl presets in both
    directions since absent flags are None)."""
    from ..encode import METHOD_EDGEBREAKER, METHOD_SEQUENTIAL, Config
    from ..models import AttributeType
    from ..shared.clers import EB_PREDICTIVE, EB_STANDARD, EB_VALENCE
    from ..shared.prediction import (PRED_DERIVATIVE,
                                     PRED_MULTI_PARALLELOGRAM)

    from ..encode.transforms import XFORM_OCT_REFLECTION, XFORM_ORTHOGONAL

    _PREDICTION_CHOICES = {
        "default": {},
        "multi": {AttributeType.POSITION: PRED_MULTI_PARALLELOGRAM},
        "derivative-uv": {AttributeType.TEX_COORD: PRED_DERIVATIVE},
    }
    _TRANSFORM_CHOICES = {
        "default": {},
        "orthogonal": {AttributeType.NORMAL: XFORM_ORTHOGONAL},
        "oct-reflection": {AttributeType.NORMAL: XFORM_OCT_REFLECTION},
    }

    quant_bits = {}
    if args.qp is not None:
        quant_bits[AttributeType.POSITION] = args.qp
    if args.qt is not None:
        quant_bits[AttributeType.TEX_COORD] = args.qt
    if args.qn is not None:
        quant_bits[AttributeType.NORMAL] = args.qn
    if args.qg is not None:
        for t in (AttributeType.COLOR, AttributeType.TANGENT,
                  AttributeType.WEIGHT):
            quant_bits[t] = args.qg
    if args.compression_level is not None:
        cfg = Config.from_level(args.compression_level)
        cfg.quant_bits = quant_bits
        if args.traversal is not None:
            cfg.traversal = {"standard": EB_STANDARD,
                             "valence": EB_VALENCE,
                             "predictive": EB_PREDICTIVE}[args.traversal]
        if args.method is not None:
            cfg.encoder_method = (METHOD_SEQUENTIAL
                                  if args.method == "sequential"
                                  else METHOD_EDGEBREAKER)
        if args.prediction is not None:
            cfg.prediction = dict(_PREDICTION_CHOICES[args.prediction])
        if args.transform is not None:
            cfg.transform = dict(_TRANSFORM_CHOICES[args.transform])
        if args.traversal_order is not None:
            cfg.attribute_traversal = args.traversal_order
        if args.sequential_method is not None:
            cfg.sequential_method = args.sequential_method
    else:
        prediction = dict(_PREDICTION_CHOICES[args.prediction or "default"])
        transform = dict(_TRANSFORM_CHOICES[args.transform or "default"])
        cfg = Config(traversal={"valence": EB_VALENCE,
                                "predictive": EB_PREDICTIVE}.get(
                         args.traversal or "standard", EB_STANDARD),
                     encoder_method=METHOD_SEQUENTIAL
                     if args.method == "sequential"
                     else METHOD_EDGEBREAKER,
                     quant_bits=quant_bits, prediction=prediction,
                     transform=transform,
                     attribute_traversal=args.traversal_order
                     or "depth-first",
                     sequential_method=args.sequential_method
                     or "direct")
    cfg.strict = args.strict_draco
    cfg.use_single_connectivity = args.single_connectivity
    return cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpudraco",
                                description="Draco codec")
    p.add_argument("-i", "--input", required=True, help="input file")
    p.add_argument("-o", "--output", required=True, help="output file")
    p.add_argument("--transcode", action="store_true",
                   help="glTF -> draco-compressed glTF")
    p.add_argument("--eval", dest="eval_json", default=None,
                   help="write per-stage metrics JSON to this path")
    p.add_argument("--traversal",
                   choices=("standard", "valence", "predictive"),
                   default=None,
                   help="edgebreaker symbol coding: 'valence' (per-context "
                        "rANS by attach-vertex valence; smallest on large "
                        "regular meshes) or 'predictive' (EdgebreakerKind=1 "
                        "— order-1 previous-symbol context rANS; the "
                        "reference declares the variant with no code). "
                        "WARNING: both are tpudraco-specific dialects — "
                        "the reference's valence coder is bit-rotted and "
                        "its predictive kind is an enum only, so there is "
                        "no cross-codec oracle; such streams decode only "
                        "with this tool (standard is Draco v2.2)")
    p.add_argument("--khr-ids", choices=("unique", "reference"),
                   default="unique",
                   help="KHR_draco_mesh_compression attribute-id mapping "
                        "for --transcode: 'unique' = the stream's actual "
                        "draco unique ids; 'reference' = the reference "
                        "encoder's Position->1/Normal->0 quirk "
                        "(encode.rs:1020-1025)")
    p.add_argument("--method", choices=("edgebreaker", "sequential"),
                   default=None,
                   help="connectivity method (sequential = raw indices, "
                        "no traversal)")
    p.add_argument("--sequential-method", choices=("direct", "compressed"),
                   default=None,
                   help="index payload for --method sequential: 'direct' "
                        "(raw width-switched indices, the only method the "
                        "reference emits) or 'compressed' (delta-coded, "
                        "method id 0 — modeled but unimplemented in the "
                        "reference; smaller on coherent index orders, "
                        "decodable by this tool)")
    p.add_argument("--strict-draco", action="store_true",
                   help="reject every tpudraco-only dialect surface "
                        "(valence, multi-parallelogram, auto symbol "
                        "coding, compressed indices, point clouds) so the "
                        "output stream is shaped exactly like the "
                        "reference encoder's; --transcode also switches "
                        "KHR ids to the reference's quirk mapping")
    p.add_argument("--prediction",
                   choices=("default", "multi", "derivative-uv"),
                   default=None,
                   help="prediction overrides: 'multi' opts positions "
                        "into averaged multi-parallelogram (wire id 2; "
                        "the reference stubs it); 'derivative-uv' opts "
                        "TEX_COORD into the derivative scheme (wire id "
                        "7; unimplemented!() dead code in the reference) "
                        "— both are tpudraco dialect surfaces, decodable "
                        "by this tool, rejected by --strict-draco")
    p.add_argument("--transform",
                   choices=("default", "orthogonal", "oct-reflection"),
                   default=None,
                   help="normal residual-transform override: 'orthogonal' "
                        "opts normals into the exact D4 orthogonal "
                        "transform (wire id 4; the reference declares the "
                        "id but its body is unimplemented!()) — no "
                        "mod-boundary ambiguity at any depth; "
                        "'oct-reflection' opts into OctReflection (wire "
                        "id 2; half-built in the reference). Both are "
                        "tpudraco dialect surfaces, decodable by this "
                        "tool, rejected by --strict-draco")
    p.add_argument("--traversal-order",
                   choices=("depth-first", "prediction-degree"),
                   default=None,
                   help="attribute traversal sequencer: 'depth-first' "
                        "(wire TraversalType=0, the only one the "
                        "reference writes) or 'prediction-degree' (wire "
                        "1 — declared but never implemented in the "
                        "reference; sequences vertices when parallelogram "
                        "support is available). Dialect surface, "
                        "decodable by this tool, rejected by "
                        "--strict-draco")
    p.add_argument("-cl", "--compression-level", type=int, default=None,
                   choices=range(0, 11), metavar="N",
                   help="compression level 0 (fastest) .. 10 (smallest); "
                        "a preset over --method/--traversal/--prediction "
                        "(explicit flags win). Levels >= 9 use the "
                        "tpudraco valence dialect")
    p.add_argument("-qp", type=int, default=None, metavar="BITS",
                   help="position quantization bits (default 11)")
    p.add_argument("-qt", type=int, default=None, metavar="BITS",
                   help="texcoord quantization bits (default 10)")
    p.add_argument("-qn", type=int, default=None, metavar="BITS",
                   help="normal octahedral quantization bits, 7..16 "
                        "(default 8 — the only depth the reference "
                        "emits; the wire carries max/center, so other "
                        "depths stay self-describing)")
    p.add_argument("-qg", type=int, default=None, metavar="BITS",
                   help="generic float attribute quantization bits "
                        "(COLOR/TANGENT/WEIGHT; draco_encoder's -qg; "
                        "default 11)")
    p.add_argument("--single-connectivity", action="store_true",
                   help="one corner table for all attributes: seams "
                        "become real cuts, no per-attribute seam streams "
                        "(the reference models this knob but its "
                        "implementation panics)")
    p.add_argument("--point-cloud", action="store_true",
                   help="encode as a point cloud (drop connectivity; "
                        "draco_encoder's -point_cloud). Face-less inputs "
                        "switch automatically. WARNING: tpudraco dialect "
                        "(see README)")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    in_ext = os.path.splitext(args.input)[1].lower()
    out_ext = os.path.splitext(args.output)[1].lower()
    t0 = time.perf_counter()

    if args.transcode or (in_ext in (".gltf", ".glb") and out_ext in (".gltf", ".glb")):
        from ..io import DracoTranscoder
        khr_ids = "reference" if args.strict_draco else args.khr_ids
        # per-primitive compression options (the reference's
        # DracoTranscodingOptions.geometry, transcoder.rs:22-41)
        cfg = _build_config(args) if any(
            v is not None for v in (args.qp, args.qt, args.qn, args.qg,
                                    args.traversal, args.prediction,
                                    args.compression_level, args.method,
                                    args.sequential_method)) \
            or args.strict_draco else None
        DracoTranscoder(khr_ids=khr_ids, cfg=cfg).transcode_file(
            args.input, args.output)
    elif out_ext == ".drc":
        from ..encode import encode
        from ..eval import EvalRecorder
        if in_ext == ".obj":
            from ..io import load_obj
            mesh = load_obj(args.input)
        elif in_ext == ".ply":
            from ..io import load_ply
            mesh = load_ply(args.input)
        elif in_ext in (".gltf", ".glb"):
            from ..io import load_gltf
            mesh = load_gltf(args.input)
        else:
            print(f"unsupported input format {in_ext}", file=sys.stderr)
            return 2
        cfg = _build_config(args)
        # face-less inputs (e.g. point-cloud PLY): encode() itself flips
        # the config to geometry type 0; --point-cloud forces it by
        # dropping connectivity
        if args.point_cloud and mesh.num_faces:
            import numpy as np

            from tpudraco.models.attribute import Attribute
            from tpudraco.models.mesh import Mesh
            # expand corner-domain attributes to per-point rows first:
            # dropping connectivity orphans their unique-value layout
            # (value rows would mispair with position rows)
            expanded = [
                Attribute(np.asarray(a.values_per_point()), a.att_type,
                          a.domain, att_id=a.att_id, name=a.name,
                          dedup=False)
                for a in mesh.attributes]
            for a, src in zip(expanded, mesh.attributes):
                a.unique_id = src.unique_id
            mesh = Mesh(faces=np.zeros((0, 3), dtype=np.int64),
                        attributes=expanded)
        rec = EvalRecorder() if args.eval_json else None
        try:
            blob = encode(mesh, cfg=cfg, recorder=rec)
        except ValueError as e:
            if "strict Draco mode" not in str(e):
                raise
            print(str(e), file=sys.stderr)
            return 2
        with open(args.output, "wb") as f:
            f.write(blob)
        if rec:
            rec.dump(args.eval_json)
    elif in_ext == ".drc":
        from ..decode import decode
        with open(args.input, "rb") as f:
            mesh = decode(f.read())
        if out_ext == ".obj":
            from ..io import save_obj
            save_obj(mesh, args.output)
        elif out_ext == ".ply":
            from ..io import save_ply
            save_ply(mesh, args.output)
        elif out_ext == ".glb":
            from ..io import save_scene_glb
            from ..models.scene import Scene
            scene = Scene()
            scene.add_mesh(mesh)
            save_scene_glb(scene, args.output, compress=False)
        else:
            print(f"unsupported output format {out_ext}", file=sys.stderr)
            return 2
    else:
        print(f"unsupported conversion {in_ext} -> {out_ext}", file=sys.stderr)
        return 2

    if not args.quiet:
        dt = time.perf_counter() - t0
        in_size = os.path.getsize(args.input)
        out_size = os.path.getsize(args.output)
        print(f"{args.input} ({in_size}B) -> {args.output} ({out_size}B) "
              f"ratio {in_size / max(out_size, 1):.2f}x in {dt:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
