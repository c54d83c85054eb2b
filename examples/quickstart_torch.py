"""Quickstart of the PyTorch port, the twin of `examples/quickstart.py`.

1. Compress a weight matrix offline (sparsify + quantize + pack).
2. Decompress-GeMM online through the plain PyTorch version (CPU tensors)
   and, on the card, through the DECA CUDA kernel (the (8, K) rows take the
   decode GeMV), and print their largest difference.
3. Ask the Roof-Surface model what bounds each scheme on SPR-HBM, and what
   DECA does about it (the paper's Figs. 5/13 in miniature).

It runs on the card unless `--device cpu`; on the CPU no kernel runs, and
the kernel column says so.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import roofsurface as rs
from repro_torch.core.compression import compress
from repro_torch.core.formats import get_spec
from repro_torch.device import resolve
from repro_torch.kernels.ops import decompress_gemm

SCHEMES = ("bf16_50", "bf8_100", "bf8_20", "mxfp4_100")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((1024, 512)).astype(np.float32))  # (K, N)
    x = torch.from_numpy(rng.standard_normal((8, 1024))).to(torch.bfloat16)  # activations

    print(f"{'scheme':10s} {'CF':>6s} {'maxerr(kernel-plain)':>20s} {'bound':>6s} "
          f"{'DECA bound':>10s}")
    for name in SCHEMES:
        spec = get_spec(name)
        ct = compress(w, spec)                  # offline (paper Fig. 1)
        y_plain = decompress_gemm(x, ct)        # online, the plain version
        if device.type == "cuda":
            on_card = dataclasses.replace(ct, **{
                p: None if getattr(ct, p) is None else getattr(ct, p).to(device)
                for p in ("codes", "mask", "scales")})
            y_kern = decompress_gemm(x.to(device), on_card)  # online, the CUDA kernel
            err = f"{float((y_kern.cpu() - y_plain).abs().max()):20.2e}"
        else:
            err = f"{'no kernel on cpu':>20s}"

        sw = rs.evaluate(spec, rs.SPR_HBM)      # software decompression
        deca = rs.evaluate(                     # with the DECA accelerator
            spec, rs.deca_profile(rs.SPR_HBM), ai_xv=rs.deca_ai_xv(spec)
        )
        print(f"{name:10s} {spec.compression_factor():6.2f} {err} "
              f"{sw.bound:>6s} {deca.bound:>10s}")

    print("\nVEC-bound schemes move to MEM/MTX-bound with DECA: the paper's "
          "core result.")


if __name__ == "__main__":
    main()
