"""End-to-end fault-tolerant training driver (the port of
``repro.launch.train``).

Runs real steps on the card (``device="cpu"`` for the plain PyTorch
version): the deterministic resumable data pipeline, AdamW, atomic and
async checkpointing through the port's ``Checkpointer``, the straggler
watchdog, optional int8 gradient compression with error feedback, and
crash-restart resume.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 100 \
      --ckpt-dir /tmp/ckpt --preset lm100m

Resume is bit-identical: the batches are a function of (seed, step), the
state saved is the whole (params, AdamWState, residuals) tree, and on
the card the step runs under ``torch.use_deterministic_algorithms``
(``deterministic()``), so that the ops whose CUDA kernels add with
atomics (the embedding gather's backward, ``index_put_`` with
``accumulate``) take their deterministic kernels, and the port's own
backward kernels add in one order.  The checkpoints are the JAX
package's format, so either package resumes the other's.

The pipeline loss (``make_pipeline_loss``) runs the layer stack through
``dist.pipeline.pipelined_apply``; with ``mesh=None`` (one process, the
trainer's case) that is its sequential branch, microbatch by microbatch.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import os
import time

import torch

from repro_torch.core.state import resolve_device
from repro_torch.data.pipeline import LMBatchSpec, lm_batch
from repro_torch.dist.pipeline import pipelined_apply, split_stages
from repro_torch.dist.sharding import tree_map
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import (LMConfig, _layer, _Mesh,
                                            init_lm_params, lm_loss)
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw
from repro_torch.optim.compression import (compress_with_feedback, decompress,
                                           init_residuals)
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.elastic import StepWatchdog

PRESETS = {
    # ~100M-param model: run on the card; CPU tests use lm_tiny
    "lm100m": LMConfig(name="lm100m", n_layers=12, d_model=768, n_heads=12,
                       n_kv_heads=4, d_ff=2048, vocab=32768, remat=False),
    "lm_tiny": LMConfig(name="lm_tiny", n_layers=2, d_model=128, n_heads=4,
                        n_kv_heads=2, d_ff=256, vocab=512, remat=False,
                        attn_chunk=64),
    # pipeline-parallel preset: 4 layers split into --pipeline-stages
    # contiguous stages (GPipe microbatch schedule, dist.pipeline)
    "lm_pipe": LMConfig(name="lm_pipe", n_layers=4, d_model=128, n_heads=4,
                        n_kv_heads=2, d_ff=256, vocab=512, remat=False,
                        attn_chunk=64),
}


@contextlib.contextmanager
def deterministic(device: torch.device, warn_only: bool = False):
    """Deterministic kernels on the card for the ``with`` block: the CUDA
    ops with atomic adds take their deterministic kernels, an op without
    one raises naming itself (warns, with ``warn_only``: how
    ``chip_smoke.py`` lists the ops that block), and ``torch.empty`` is
    not filled.  The cuBLAS workspace setting must be in the environment
    before the process's first product (``CUBLAS_WORKSPACE_CONFIG``;
    ``main`` sets it); without it a product on the card raises here.  On
    the CPU the block runs as it is (its kernels are deterministic)."""
    if device.type != "cuda":
        yield
        return
    import torch.utils.deterministic as tud
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           tud.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    tud.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        tud.fill_uninitialized_memory = was[2]


def make_pipeline_loss(cfg: LMConfig, n_stages: int, mesh=None,
                       n_micro: int | None = None):
    """LM loss with the layer stack run through ``pipelined_apply``.

    The parameters are layer-stacked, so ``split_stages`` carves them into
    S contiguous stages and each stage loops over its own ``[L/S, ...]``
    slice.  The batch axis supplies the microbatches.  With ``mesh`` None
    (or no ``pipe`` axis) ``pipelined_apply`` runs its sequential branch,
    so the same loss runs in one process."""
    if cfg.n_experts:
        raise ValueError("pipeline loss supports dense FFN presets only "
                         "(MoE aux loss is not threaded through stages)")
    M = n_micro or n_stages

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        B, T = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} microbatches")
        mb = B // M
        positions = torch.arange(T, device=tokens.device).expand(mb, T)
        x = params["embed"][tokens].to(cfg.compute_dtype)
        xs = x.reshape(M, mb, T, x.shape[-1])
        stages = split_stages(params["layers"], n_stages)

        def stage_fn(sp, h):
            for i in range(next(iter(sp.values())).shape[0]):
                lp = {k: v[i] for k, v in sp.items()}
                (h,), _ = _layer(cfg, _Mesh(), [lp], None, [h], [positions])
            return h

        x = pipelined_apply(stage_fn, stages, xs, mesh)
        x = rms_norm(x.reshape(B, T, x.shape[-1]), params["final_norm"])
        logits = x @ params["unembed"].to(cfg.compute_dtype)
        tgt = logits.gather(-1, batch["targets"][..., None].long())[..., 0]
        lse = torch.logsumexp(logits.float(), dim=-1)
        return (lse - tgt.float()).mean()

    return loss_fn


def make_train_step(cfg: LMConfig, opt_cfg: AdamWConfig, compress: bool,
                    pipeline_stages: int = 0, mesh=None,
                    n_micro: int | None = None):
    """``step(params, opt, residuals, batch) -> (params, opt, residuals,
    loss, gnorm)``; params and the moments are updated in place."""
    loss_fn = (make_pipeline_loss(cfg, pipeline_stages, mesh, n_micro)
               if pipeline_stages > 1
               else functools.partial(lm_loss, cfg))

    def step(params, opt, residuals, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if compress:
            # the inter-pod gradient path: int8 + error feedback
            comp, residuals = compress_with_feedback(grads, residuals)
            grads = decompress(comp, grads)
        params, opt, gnorm = adamw_update(opt_cfg, grads, opt, params)
        return params, opt, residuals, loss, gnorm
    return step


def _on(tree, device):
    return tree_map(lambda a: torch.as_tensor(a, device=device), tree)


def train(cfg: LMConfig, steps: int, batch: int, seq: int,
          ckpt_dir: str | None, ckpt_every: int = 50, compress: bool = False,
          watchdog_s: float = 0.0, log_every: int = 10, seed: int = 0,
          pipeline_stages: int = 0, n_micro: int | None = None,
          device=None):
    """Train ``cfg`` for ``steps`` steps on ``device`` (default the card);
    resumes from the newest checkpoint under ``ckpt_dir``.  Returns
    (params, losses of the steps run here).  The parameters are drawn
    from a ``torch.Generator`` seeded ``seed`` on the device (JAX's
    ``PRNGKey(seed)`` draws others: a run restored from a JAX checkpoint
    continues JAX's)."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(total_steps=steps)
    if pipeline_stages > 1:
        print(f"[train] pipeline: {pipeline_stages} stages, sequential "
              f"branch (one process)")
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    opt = init_adamw(params)
    residuals = init_residuals(params) if compress else \
        tree_map(lambda x: torch.zeros((), device=dev), params)
    bspec = LMBatchSpec(batch=batch, seq_len=seq, vocab=cfg.vocab, seed=seed)
    start = 0
    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ck and ck.latest_step() is not None:
        tree, extra, start = ck.restore((params, opt, residuals))
        params, opt, residuals = _on(tree, dev)
        print(f"[train] resumed from step {start} ({extra})")
    step_fn = make_train_step(cfg, opt_cfg, compress, pipeline_stages, None,
                              n_micro)
    wd = StepWatchdog(watchdog_s) if watchdog_s > 0 else None
    losses = []
    t0 = time.time()
    with deterministic(dev):
        for s in range(start, steps):
            if wd:
                wd.arm(s)
            b = _on(lm_batch(bspec, s), dev)
            params, opt, residuals, loss, gnorm = step_fn(
                params, opt, residuals, b)
            loss = float(loss)
            if wd:
                wd.disarm()
            losses.append(loss)
            if s % log_every == 0 or s == steps - 1:
                print(f"[train] step {s} loss {loss:.4f} "
                      f"gnorm {float(gnorm):.3f} ({time.time() - t0:.1f}s)")
            if ck and (s + 1) % ckpt_every == 0:
                ck.save_async(s + 1, (params, opt, residuals),
                              extra=dict(loss=loss))
    if ck:
        ck.wait()
        ck.save(steps, (params, opt, residuals),
                extra=dict(loss=losses[-1] if losses else None))
    return params, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="lm_tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--watchdog-s", type=float, default=0.0)
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="split the layer stack into N pipeline stages "
                         "(the sequential branch in one process; 0/1 = off)")
    ap.add_argument("--micro", type=int, default=None,
                    help="microbatch count for the pipeline schedule "
                         "(default: one per stage)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    # the deterministic cuBLAS workspace, read at the first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = PRESETS[args.preset]
    _, losses = train(cfg, args.steps, args.batch, args.seq,
                      args.ckpt_dir, args.ckpt_every, args.compress,
                      args.watchdog_s, pipeline_stages=args.pipeline_stages,
                      n_micro=args.micro, device=args.device)
    if losses:
        print(f"[train] done. first loss {losses[0]:.4f} -> "
              f"last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
