"""The spread of GraphCast's f32 gradient step, on one NVIDIA card.

    python3 tools/graphcast_grad_spread.py [--runs 4]

Builds the scatter-SpMM library and draws ``chip_smoke.py`` phase 50's
GraphCast step (full_graph_sm, full width, 16 processor layers) as the
phase does: the families before it are drawn from the phase's generator
first and dropped, so the weights and regression targets are the
phase's.  Then takes the
grad step ``--runs`` times through the kernels, ``--runs`` times with
every kernel replaced by its plain version (``index_add_`` sums), and
once in float64 in plain torch ops (``chip_smoke.graphcast_loss64``),
and prints, as the largest over the 168 gradient leaves of max |a - b| /
max |b|:

* each f32 run against the f64 step;
* each run against the first run of its own kind (the plain step's
  ``index_add_`` adds in an order that changes from run to run);
* each kernel run against each plain run, which is what phase 50 held
  them to before it took the f64 step as the reference;

and the f64 step's peak memory.

Ends with one JSON line of the numbers.  Needs one card; about a minute.
"""
import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def worst(grads, ref) -> float:
    return max(cs.leaf_dist(a, r)[0] for a, r in zip(grads, ref))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("graphcast_grad_spread: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.spmm_ops.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(50)
    cases = cs.family_cases(gen, dev)
    for tag, loss, params, _, options in cases:
        if tag.startswith("graphcast"):
            break
        del loss, params, options
    kern = [cs.grad_step(loss, params)[1] for _ in range(args.runs)]
    with cs.plain_kernels():
        plain = [cs.grad_step(loss, params)[1] for _ in range(args.runs)]
    torch.cuda.reset_peak_memory_stats()
    ref = cs.grad_step(options["loss64"], params)[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"the f64 step's peak: {peak:.2f} GiB", flush=True)
    out = dict(card=smi, runs=args.runs, f64_peak_gib=peak,
               kernel_vs_f64=[worst(g, ref) for g in kern],
               plain_vs_f64=[worst(g, ref) for g in plain],
               kernel_vs_first_kernel=[worst(g, kern[0]) for g in kern[1:]],
               plain_vs_first_plain=[worst(g, plain[0]) for g in plain[1:]],
               kernel_vs_plain=[worst(a, b) for a in kern for b in plain])
    for key, vals in out.items():
        if isinstance(vals, list):
            print(f"{key}: " + ", ".join(f"{v:.4g}" for v in vals),
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
