"""Command line of the PyTorch port: the reference's flags
(floria_tpu.cli.build_parser) plus `--device`.

    python -m floria_tpu_torch.cli -b BAM -v VCF -r FASTA -o OUT \
        [--device cuda|cpu]

`--device` defaults to cuda and raises when no CUDA device is present.
"""

from __future__ import annotations

from floria_tpu.cli import build_parser as _reference_parser
from floria_tpu.cli import options_from_args

from .device import resolve_device
from .pipeline import run


def build_parser():
    p = _reference_parser()
    p.prog = "floria-tpu-torch"
    p.add_argument("--device", default="cuda",
                   help="Torch device for the phasing kernels: cuda "
                        "(default; raises without a GPU) or cpu (the "
                        "plain PyTorch path).")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.num_processes > 1:
        raise NotImplementedError(
            "--num-processes > 1: multi-host runs are a later ROADMAP "
            "item (queue 1: parallel/multihost.py)")
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            "--num-devices > 1: the multi-device sweep is a later "
            "ROADMAP item (queue 1: multi-device sweep and "
            "parallel/mesh.py)")
    options = options_from_args(args)
    run(options, device=device)


if __name__ == "__main__":
    main()
