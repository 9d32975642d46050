"""Training launcher, the port of the JAX package's ``launch/train.py``: on
the card unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
        --steps 200 --batch 8 --seq 128 --reduced [--device cpu]

Checkpoints (``--ckpt-every``, ``--resume``) keep the reference's layout:
``state-{step:06d}.npz`` and ``latest.json`` in ``--ckpt-dir``, the npz's
names ``jax.tree_util.keystr`` of the reference's ``(params, opt)`` tree
(pattern groups stacked, bf16 widened to float32), so either package
resumes from the other's files.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import (
    array_from_tensor, keystr, lm_tree_from_named, tree_leaves,
)
from repro_torch.data.tokens import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train import init_train_state, make_train_step


def _state(model, opt: dict) -> dict[str, dict[str, torch.Tensor]]:
    """The weights and ``opt``'s moments (and error buffer) by the prefix
    of their npz names: ``[0]``, ``[1]['mu']``, ``[1]['nu']``,
    ``[1]['err']``."""
    out = {"[0]": dict(model.named_parameters())}
    out.update({f"[1][{k!r}]": opt[k] for k in ("mu", "nu", "err")
                if k in opt})
    return out


def save_train_ckpt(path: str, step: int, model, opt: dict) -> None:
    """``state-{step:06d}.npz`` of the weights and ``opt`` under the
    reference's names (its trees, as ``lm_arrays_from_params`` makes
    them), then ``latest.json``."""
    os.makedirs(path, exist_ok=True)
    arrs = {"[1]['step']": array_from_tensor(opt["step"])}
    for pre, leaves in _state(model, opt).items():
        tree = lm_tree_from_named(model.cfg, {n: array_from_tensor(t)
                                              for n, t in leaves.items()})
        arrs.update({pre + keystr(p): a for p, a in tree_leaves(tree)})
    np.savez(os.path.join(path, f"state-{step:06d}.npz"), **arrs)
    with open(os.path.join(path, "latest.json"), "w") as f:
        json.dump(dict(step=step), f)


@torch.no_grad()
def restore_train_ckpt(path: str, model, opt: dict):
    """Read ``latest.json``'s checkpoint into the model's weights and
    ``opt`` in place, each narrowed to its own dtype; returns ``(step,
    model, opt)``. A file without one of their names raises ``KeyError``,
    one of another shape ``ValueError``."""
    with open(os.path.join(path, "latest.json")) as f:
        step = json.load(f)["step"]
    with np.load(os.path.join(path, f"state-{step:06d}.npz")) as z:
        for pre, leaves in _state(model, opt).items():
            # the tree of the tensors' names: a stacked leaf holds its
            # layers' names in order
            names = lm_tree_from_named(model.cfg,
                                       {n: np.array(n) for n in leaves})
            for p, leaf in tree_leaves(names):
                key = pre + keystr(p)
                a = z[key]
                if leaf.ndim == 0:
                    parts = [(str(leaf), a)]
                elif a.shape[:1] != leaf.shape:
                    raise ValueError(f"{key} stacks {a.shape[:1]}, the "
                                     f"model {leaf.shape}")
                else:
                    parts = zip(map(str, leaf), a)
                for n, part in parts:
                    t = leaves[n]
                    if tuple(part.shape) != tuple(t.shape):
                        raise ValueError(f"{key}: {part.shape}, the model "
                                         f"{tuple(t.shape)}")
                    t.copy_(torch.from_numpy(np.ascontiguousarray(part)))
        opt["step"] = torch.tensor(int(z["[1]['step']"]), dtype=torch.int32,
                                   device=opt["step"].device)
    return step, model, opt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="ckpt_train")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params "
          f"({cfg.n_active_params()/1e6:.1f}M active), "
          f"batch={args.batch}x{args.seq} on {device}")

    model = init_params(cfg, args.seed, device)
    opt = init_train_state(cfg, model)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    start = 0
    if args.resume and os.path.exists(
        os.path.join(args.ckpt_dir, "latest.json")
    ):
        start, model, opt = restore_train_ckpt(args.ckpt_dir, model, opt)
        print(f"[train] resumed at step {start}")

    tokens_per_step = args.batch * args.seq
    t_start = time.perf_counter()
    loss = float("nan")
    for s in range(start, args.steps):
        batch = synthetic_batch(cfg, s, args.seq, args.batch, device=device)
        t0 = time.perf_counter()
        model, opt, m = step_fn(model, opt, batch)
        loss = float(m["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        if s % max(args.steps // 20, 1) == 0 or s == args.steps - 1:
            print(f"  step {s:5d}  loss {loss:.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"{tokens_per_step / dt:.0f} tok/s")
        if args.ckpt_every and (s + 1) % args.ckpt_every == 0:
            save_train_ckpt(args.ckpt_dir, s + 1, model, opt)
    total = time.perf_counter() - t_start
    print(f"[train] done: {args.steps - start} steps in {total:.1f}s, "
          f"final loss {loss:.4f}")


if __name__ == "__main__":
    main()
