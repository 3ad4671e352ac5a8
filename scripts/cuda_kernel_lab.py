"""Kernel lab of the PyTorch port on an NVIDIA GPU: rate probes of the card
and variants of the dense pull, each kernel held to its plain version.

The counterpart of the JAX package's TPU kernel labs
(``scripts/tpu_kernel_lab*.py``); the kernels are ``interpol_tpu_torch/
csrc/lab.cu`` and the dense warp's (``csrc/warp.cu``), the runners
``interpol_tpu_torch/ops/lab.py``.  Every line names the card
(``nvidia-smi``'s name and power limit).

Run:  python scripts/cuda_kernel_lab.py [N] [variants...]

variants (all by default):
  fma fma2 fma2bf fma3 fma3n4 fma3n16 fma3bf
              FMA chains (float32 or bf16 pairs, 1-16 chains per element)
  gather      lab 1's lane gather: an (8, 8, 2N) table, (8, 8, N) indices
  lane[:TAB[:REPS]]
              lab 5's chained gather from a shared-memory table of TAB
              entries per row (2304, 64 reads by default)
  smem l1 l2 vol256 hbm
              the gather tables of ops/lab.py::GATHER_TABLES
  v4          the bf16 pull (lab 2's _kernel_v4) at N^3 beside kernel 1a
  pull        kernel 1a under each block shape, kernel 1d on a smooth field
  mxubf mxuf32 xlafma
              yardsticks: torch.matmul in bf16 / float32, an elementwise
              FMA chain
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from interpol_tpu_torch.ops import lab  # noqa: E402

ALL = (list(lab.FMA_VARIANTS) + ["gather", "lane"] + list(lab.GATHER_TABLES)
       + ["v4", "pull", "mxubf", "mxuf32", "xlafma"])


def _fmt(r: dict) -> str:
    return "  ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in r.items())


def run(variant: str, N: int) -> dict:
    name, *args = variant.split(":")
    if name in lab.FMA_VARIANTS:
        return lab.fma_probe(name)
    if name == "gather":
        return lab.gather_probe("smem", tab=2 * N, reps=1, groups=8,
                                lanes=N)
    if name == "lane":
        tab = int(args[0]) if args else 2304
        reps = int(args[1]) if len(args) > 1 else 64
        return lab.gather_probe("smem", tab=tab, reps=reps)
    if name in lab.GATHER_TABLES:
        return lab.gather_probe(name)
    if name == "v4":
        return lab.pull_bf16_probe(N)
    if name == "pull":
        return {r["variant"]: round(r["ms"], 4) for r in
                lab.pull_variants(N)}
    if name in ("mxubf", "mxuf32"):
        dt = torch.bfloat16 if name == "mxubf" else torch.float32
        return lab.matmul_probe(dt, reps=64)
    if name == "xlafma":
        return lab.chain_probe()
    raise ValueError(f"unknown variant {variant}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cuda_kernel_lab: needs an NVIDIA GPU")
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    card = lab.card_line()
    print(f"card: {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda}", flush=True)
    for v in sys.argv[2:] or ALL:
        try:
            print(f"{v:8s} {_fmt(run(v, N))} [{card}]", flush=True)
        except Exception as e:           # report and go on, as the labs do
            print(f"{v:8s} FAILED: {type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
