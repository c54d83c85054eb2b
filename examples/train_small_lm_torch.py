"""End-to-end training driver of the PyTorch port, the twin of
`examples/train_small_lm.py`: train a reduced llama on the synthetic
pipeline with checkpointing and restart.

Presets: 10m (CPU-friendly default), 100m (same code path, bigger dims).
The loop exercises the port's training substrate: the data pipeline, AdamW
on the warmup-cosine schedule, remat, `Checkpointer` save and resume, and
the straggler watchdog. It runs on the card unless `--device cpu`.

Run:  PYTHONPATH=src python examples/train_small_lm_torch.py --steps 200
      PYTHONPATH=src python examples/train_small_lm_torch.py --device cpu --steps 30
Re-running with the same --ckpt-dir resumes from its latest checkpoint.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.device import resolve
from repro_torch.dist.fault import StragglerWatchdog
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import AdamW, warmup_cosine
from repro_torch.train.trainer import device_batch, make_train_step

PRESETS = {
    "10m": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2, d_head=64,
                d_ff=1536, vocab_size=2048),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
                 d_ff=3072, vocab_size=32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = ModelConfig(name=f"llama-{args.preset}", family="dense",
                      mlp_act="swiglu", tie_embeddings=True, **PRESETS[args.preset])
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params on {device}")
    model = Model(cfg)
    opt = AdamW(lr=lambda s: warmup_cosine(s, peak_lr=1e-3, warmup=20, total=args.steps))
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", "train", args.seq, args.batch))
    ckpt = Checkpointer(args.ckpt_dir, keep=2)

    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    opt_state = opt.init(params)
    start = 0
    if ckpt.latest_step() is not None:
        start, tree = ckpt.restore({"params": params, "opt_state": opt_state})
        params, opt_state = tree["params"], tree["opt_state"]
        print(f"resumed from step {start}")

    step_fn = make_train_step(model, opt)
    watchdog = StragglerWatchdog()
    t_start = time.perf_counter()
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = device_batch(pipe.batch(step), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if watchdog.observe(step, dt):
            print(f"  [straggler watchdog] step {step} took {dt:.2f}s")
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {loss:.4f}  {dt*1e3:.0f} ms/step")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, params, opt_state)
    ckpt.wait()
    total = time.perf_counter() - t_start
    tok_s = (args.steps - start) * args.batch * args.seq / total
    print(f"done: {total:.1f}s, {tok_s:.0f} tok/s; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
