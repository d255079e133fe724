"""LM serving (the port of ``repro.launch.serve``, with the prefill step of
``repro.launch.steps._lm_prefill_plan``).

``serve`` is the continuous-batching-lite decode loop: fixed batch slots,
each slot one request with its own cache length; a finished request is
replaced from the queue without stopping the batch (the decode step is
length-masked, so ragged slots are free).  Prompts are fed one token a
step, as in the JAX package.  ``prefill`` is the production prefill: one
causal forward over ``[B, T]`` prompts, returning the last-token logits,
its attention one launch of the flash-attention kernel a layer.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.state import resolve_device
from repro_torch.models.transformer import (LMConfig, init_kv_cache,
                                            init_lm_params, lm_decode_step,
                                            lm_trunk)
from repro_torch.obs.metrics import render_summary, summarize

# the JAX package's presets (``repro/launch/train.py``); they move to the
# port's launch/train.py with the training slice
PRESETS = {
    # ~100M-param model, for the card; the CPU tests use lm_tiny
    "lm100m": LMConfig(name="lm100m", n_layers=12, d_model=768, n_heads=12,
                       n_kv_heads=4, d_ff=2048, vocab=32768, remat=False),
    "lm_tiny": LMConfig(name="lm_tiny", n_layers=2, d_model=128, n_heads=4,
                        n_kv_heads=2, d_ff=256, vocab=512, remat=False,
                        attn_chunk=64),
}


@torch.no_grad()
def prefill(cfg: LMConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> the last token's logits [B, vocab] (compute dtype).
    The unembedding is applied to the last position only: the numbers of
    ``lm_forward(...)[0][:, -1]``, without the [B, T, vocab] logits."""
    x = lm_trunk(cfg, params, tokens)
    return x[:, -1] @ params["unembed"].to(cfg.compute_dtype)


@torch.no_grad()
def serve(cfg: LMConfig, n_requests: int, batch: int, prompt_len: int = 16,
          gen_len: int = 24, max_len: int = 128, seed: int = 0, params=None,
          device=None):
    """Serve ``n_requests`` random prompts through ``batch`` slots.
    ``params=None`` draws them from a generator seeded by ``seed`` on the
    device (default ``cuda``).  Returns (generated tokens by request,
    aggregate tokens/s, metrics); a step's latency runs until the host
    holds the next tokens."""
    dev = resolve_device(device)
    if params is None:
        params = init_lm_params(
            cfg, torch.Generator(device=dev).manual_seed(seed))
    cache = init_kv_cache(cfg, batch, max_len, device=dev)
    lengths = np.zeros(batch, np.int32)       # host copy, sent each step
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
             for _ in range(n_requests)]
    slots = [None] * batch          # request id per slot
    remaining = [0] * batch
    done, submitted = 0, 0
    tokens_out = {i: [] for i in range(n_requests)}
    cur = np.zeros(batch, np.int32)
    t0 = time.perf_counter()
    n_steps = 0
    step_times = []          # per-decode-step wall latency
    while done < n_requests:
        # fill free slots (prefill = feeding prompt tokens one step at a
        # time here, as in the JAX package; the production prefill path
        # is ``prefill``)
        for b in range(batch):
            if slots[b] is None and submitted < n_requests:
                slots[b] = submitted
                remaining[b] = prompt_len + gen_len
                lengths[b] = 0
                submitted += 1
        # choose the next input token per slot
        nxt = np.zeros(batch, np.int32)
        for b in range(batch):
            rid = slots[b]
            if rid is not None:
                pos = lengths[b]
                nxt[b] = queue[rid][pos] if pos < prompt_len else cur[b]
        ts = time.perf_counter()
        logits, cache = lm_decode_step(
            cfg, params, torch.tensor(nxt[:, None], device=dev), cache,
            torch.tensor(lengths, device=dev))
        cur = logits[:, -1].argmax(dim=-1).to(torch.int32).cpu().numpy()
        step_times.append(time.perf_counter() - ts)
        lengths += np.array([s is not None for s in slots], np.int32)
        n_steps += 1
        for b in range(batch):
            if slots[b] is None:
                continue
            rid = slots[b]
            if lengths[b] > prompt_len:
                tokens_out[rid].append(int(cur[b]))
            remaining[b] -= 1
            if remaining[b] <= 0:
                slots[b] = None
                done += 1
    dt = time.perf_counter() - t0
    tput = n_steps * batch / dt
    print(f"[serve] {n_requests} requests, {n_steps} steps, "
          f"{tput:.1f} tok/s aggregate")
    # decode-step latency percentiles; step 0 (first use of the device's
    # kernels and allocator) is reported separately
    print(render_summary("serve/decode_step", step_times[1:]))
    metrics = summarize([x * 1e3 for x in step_times[1:]], "ms")
    metrics.update(first_step_ms=step_times[0] * 1e3, tok_per_s=tput,
                   steps=n_steps)
    return tokens_out, tput, metrics


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="lm_tiny", choices=sorted(PRESETS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    serve(PRESETS[args.preset], args.requests, args.batch,
          gen_len=args.gen_len, device=args.device)


if __name__ == "__main__":
    main()
