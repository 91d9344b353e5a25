"""Physics-parameter estimation CLI: object image -> simulator params.

A port of robosimgs_tpu/cli/estimate_physics.py, the counterpart of the
upstream RoboSimGS `Articulation/physics_estimation.py` command line,
with every model behind an interface: offline mode uses table priors;
--mllm openai enables the full caption -> coarse -> zero-shot -> refine
flow. The input image is read by utils/imresize.py's PNG reader, without
Pillow, so it must be a PNG (8-bit, any colour type); a JPEG exits with
a message. Nothing here runs on a device.

    python -m robosimgs_tpu_torch.cli.estimate_physics object.png --output physics.json
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="Image -> simulator material params")
    p.add_argument("input", help="object image (8-bit PNG)")
    p.add_argument("--output", default=None, help="output json path")
    p.add_argument("--caption", default=None,
                   help="object caption (skips the captioner)")
    p.add_argument("--material", default=None,
                   help="force a material (skips coarse+zero-shot)")
    p.add_argument("--method", default=None, choices=[None, "mpm", "pbd"])
    p.add_argument("--mllm", default="none", choices=["none", "openai"])
    p.add_argument("--scripted", default=None, metavar="SPEC_JSON",
                   help="drive the full flow headless with scripted fakes: "
                        'JSON {"caption": str, "responses": [[needle, '
                        'response], ...], "preferences": {label: weight}} '
                        "(tests/golden uses this for the e2e artifact)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from robosimgs_tpu_torch.artic.mllm import StaticCaptioner
    from robosimgs_tpu_torch.artic.physics import (PhysicsEstimator,
                                                   load_material_table)
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb

    try:
        img = read_png_rgb(args.input).astype(np.float32) / 255.0
    except ValueError as e:
        raise SystemExit(f"estimate_physics: {e}. Only PNG input is read: "
                         f"images are decoded without Pillow, so convert "
                         f"JPEG and other formats to an 8-bit PNG first")
    out_path = args.output or os.path.splitext(args.input)[0] + "_physics.json"

    if args.material:
        method = args.method or "mpm"
        table = load_material_table(method)
        row = table.get(args.material)
        if row is None:
            raise SystemExit(f"unknown material {args.material}; "
                             f"options: {sorted(table)}")
        import json
        if method == "mpm":
            params = {"density": row.get("density", 1000.0),
                      "youngs_modulus": row["youngsModulus"],
                      "poisson_ratio": row["poissonRatio"]}
        else:
            params = {k: row[k] for k in ("static_friction", "kinetic_friction",
                                          "stretch_compliance")}
            params["density"] = row.get("density", 1000.0)
        result = {"method": method, "material": args.material, "params": params}
        with open(out_path, "w") as fh:
            json.dump(result, fh, indent=2)
        print(json.dumps(result, indent=2))
        return

    mllm, scorer = None, None
    if args.mllm == "openai":
        from robosimgs_tpu_torch.artic.mllm import OpenAIChat
        mllm = OpenAIChat()
    captioner = StaticCaptioner(args.caption) if args.caption else None
    if args.scripted:
        import json
        from robosimgs_tpu_torch.artic.mllm import ScriptedMLLM, UniformScorer
        spec = json.load(open(args.scripted))
        mllm = ScriptedMLLM(responses=[tuple(r) for r in spec["responses"]],
                            default=spec.get("default"))
        if spec.get("caption"):
            captioner = StaticCaptioner(spec["caption"])
        if spec.get("preferences"):
            scorer = UniformScorer(spec["preferences"])
    est = PhysicsEstimator(captioner=captioner, scorer=scorer,
                           mllm=mllm).estimate(img, out_path=out_path)
    print(f"method={est.method} material={est.material} params={est.params}")
    print(f"saved {out_path}")


if __name__ == "__main__":
    main()
