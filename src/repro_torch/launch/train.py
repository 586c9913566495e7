"""Fault-tolerant training driver.

A port of the JAX package's ``launch/train.py``.  End to end: synthetic
corpus -> packed shards (sequence-file style) -> deterministic pipeline ->
train step on one device -> periodic atomic checkpoints ->
restart-on-failure.  It runs on the card unless ``--device cpu`` is given.

Failure drill: ``--crash-at-step N`` exits nonzero after step N, once the
checkpoints due by then are committed (with ``--ckpt-every 4`` and N = 6
the last is step 4's), simulating a node loss; re-running the same command
with the same ``--run-dir`` resumes from the latest checkpoint and, by the
pipeline's pure-function-of-step contract, consumes exactly the batches it
would have seen without the crash.  As in the JAX package, the generator of
the stubbed frontends' inputs (``enc_frames``, ``img_embeds``) restarts at
seed 1234 on every start, so a resumed ``encdec`` or ``vlm`` run draws other
inputs than an uninterrupted one.

`train` runs the loop for parsed arguments and, optionally, a
`ModelConfig` object in place of ``--arch`` (so a caller can train a config
the registry does not name).  ``result.json`` in the run directory holds
``final_loss``, ``losses``, ``wall_s`` and ``tokens_per_s``.

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen2-1.5b \\
      --reduced --steps 30 --global-batch 8 --seq-len 64 --run-dir /tmp/run1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.packing import pack_documents, synthetic_corpus
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.specs import make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import warmup_cosine


def build_everything(args, cfg: Optional[ModelConfig] = None):
    """-> (cfg, model, pipeline, train step) for parsed ``args``; ``cfg``
    replaces ``--arch`` / ``--reduced`` when given."""
    from repro_torch.configs.registry import get_config, reduced_config

    if cfg is None:
        cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    model = build_model(cfg, device=args.device)

    docs, srcs = synthetic_corpus(n_docs=args.n_docs, vocab=cfg.vocab_size, seed=args.data_seed)
    shards = pack_documents(docs, srcs, shard_len=max(args.seq_len * 4, 512))
    pipe = TokenPipeline(shards, PipelineConfig(args.global_batch, args.seq_len,
                                                seed=args.data_seed))
    ocfg = AdamWConfig(lr=args.lr, schedule=warmup_cosine(args.warmup, args.steps))
    return cfg, model, pipe, make_train_step(model, ocfg)


def add_batch_extras(batch, cfg: ModelConfig, rng: np.random.Generator):
    """The stubbed frontends' inputs, drawn from ``rng`` (the JAX package's draws)."""
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.standard_normal(
            (batch["tokens"].shape[0], cfg.encoder_seq, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal(
            (batch["tokens"].shape[0], cfg.n_image_tokens, cfg.d_model), np.float32)
    return batch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train an LM of the registry on synthetic data.")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--n-docs", type=int, default=256)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--init-seed", type=int, default=0)
    ap.add_argument("--run-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_run"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--crash-at-step", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def train(args, cfg: Optional[ModelConfig] = None) -> dict:
    """The training loop for parsed ``args`` -> the result written to
    ``result.json``.  Raises SystemExit at ``--crash-at-step``."""
    cfg, model, pipe, step_fn = build_everything(args, cfg)
    ckpt = CheckpointManager(os.path.join(args.run_dir, "ckpt"))
    dev = model.device

    params = model.init(args.init_seed)
    opt_state = adamw_init(params)
    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        _, state = ckpt.restore(latest, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = latest
        print(f"[resume] from step {start}", flush=True)

    extras_rng = np.random.default_rng(1234)
    losses = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = add_batch_extras(pipe.batch_at(step), cfg, extras_rng)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
        if args.crash_at_step == step:
            ckpt.wait()
            raise SystemExit(f"[drill] injected crash after step {step}")
    ckpt.wait()
    dt = time.perf_counter() - t0

    out = {
        "arch": cfg.name,
        "device": str(dev),
        "steps": args.steps,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "wall_s": dt,
        "tokens_per_s": args.global_batch * args.seq_len * max(len(losses), 1) / dt,
    }
    os.makedirs(args.run_dir, exist_ok=True)
    with open(os.path.join(args.run_dir, "result.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    out = train(parser().parse_args(argv))
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}, indent=1))


if __name__ == "__main__":
    main()
