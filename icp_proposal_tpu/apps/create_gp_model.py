"""CLI: build GPMMs from analytic kernels (offline model construction).

Equivalents of reference ``apps/femur/CreateGPModel.scala`` (femur: builds
the 50/100/200-component models from the anisotropic multi-scale Gaussian
kernel) and ``apps/bfm/CreateGPModel.scala`` (face: FaceKernel + Nyström on a
decimated reference).

    python -m icp_proposal_tpu.apps.create_gp_model femur \
        --reference femur_reference.stl \
        --components 50 100 200 --out-dir ./models
    python -m icp_proposal_tpu.apps.create_gp_model face \
        --reference ref.stl --components 200 --out models/faceGPmodel_200c.h5
"""
from __future__ import annotations

import argparse
import os


def main():
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pf = sub.add_parser("femur")
    pf.add_argument("--reference", required=True)
    pf.add_argument("--components", type=int, nargs="+", default=[50, 100, 200])
    pf.add_argument("--out-dir", default=".")

    pb = sub.add_parser("face")
    pb.add_argument("--reference", required=True)
    pb.add_argument("--components", type=int, default=200)
    pb.add_argument("--decimate-to", type=int, default=2000)
    pb.add_argument("--sample-points", type=int, default=800)
    pb.add_argument("--out", required=True)

    args = p.parse_args()

    from icp_proposal_tpu.io.statismo import write_statismo_gpmm
    from icp_proposal_tpu.io.stl import read_stl

    points, cells = read_stl(args.reference)
    print(f"reference: {len(points)} vertices / {len(cells)} faces")

    if args.cmd == "femur":
        from icp_proposal_tpu.models.build_femur import (
            build_femur_gpmm,
            femur_kernel,
            variance_capture_ratio,
        )

        os.makedirs(args.out_dir, exist_ok=True)
        for i in args.components:
            model = build_femur_gpmm(points, cells, num_components=i)
            ratio = variance_capture_ratio(
                femur_kernel(points), points, model.variance
            )
            out = os.path.join(args.out_dir, f"femur_gp_model_{i}-components.h5")
            write_statismo_gpmm(out, model)
            print(
                f"wrote {out}: rank {model.rank}, "
                f"variance-capture ratio {ratio:.3f}"
            )
    else:
        from icp_proposal_tpu.models.build_face import build_face_gpmm

        model = build_face_gpmm(
            points, cells,
            num_components=args.components,
            num_sample_points=args.sample_points,
            decimate_to=args.decimate_to,
        )
        write_statismo_gpmm(args.out, model)
        print(f"wrote {args.out}: {model.num_points} vertices, rank {model.rank}")


if __name__ == "__main__":
    main()
