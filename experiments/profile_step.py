"""Device-time attribution of one training or evaluation step from a trace.

Runs a config's train step (XLA scan path: loss, grad, Adam) or one
evaluation forward pass under jax.profiler, reads the `.xplane.pb` the
profiler writes, and reports per step:
- the wall time on the host clock (around jax.block_until_ready), of an
  untraced window and of the traced one (the tracer slows the host);
- device busy time: the union of kernel intervals on the GPU's stream lines;
- the device idle share, 1 - busy / wall, over the traced window, and busy
  over the untraced wall (the tracer also lengthens each kernel a little,
  so with many tiny kernels this can exceed 1);
- kernels launched per step;
- busy time by kernel class (matmul library, XLA fusion, copy, collective)
  and the top kernels by time.

Usage (one process per card; it opens the card itself):
  python -m experiments.profile_step many_gmm --mode MCD_CAIS_var_sn \
      --nbridges 256 --n 2000 --emb_dim 130
  python -m experiments.profile_step many_gmm --eval --nbridges 256 --n 2000
  python -m experiments.profile_step lgcp --nbridges 256 --n 128
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time
from collections import defaultdict

import jax
import jax.numpy as jnp


def _window(step, state, steps):
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    jax.block_until_ready(state)
    return state, (time.perf_counter() - t0) / steps


def run_traced(step, state, steps, trace_dir):
    """Warm up (compile), time `steps` chained calls untraced, then trace as
    many. Returns host wall seconds per call (untraced, traced)."""
    state = jax.block_until_ready(step(state))
    state = jax.block_until_ready(step(state))
    state, untraced = _window(step, state, steps)
    jax.profiler.start_trace(trace_dir)
    state, traced = _window(step, state, steps)
    jax.profiler.stop_trace()
    return untraced, traced


def _union_length(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def parse_trace(trace_dir, steps):
    """Reduce the newest `.xplane.pb` under trace_dir.

    Device planes are the ones named `/device:GPU:<i>`. Their `Stream ...`
    lines hold the kernels as they ran; the `XLA Modules`, `XLA Ops` and
    `Steps` lines are annotations spanning those kernels and are left out.
    Returns (busy_s_per_step, {kernel name: s per step}, lines), where lines
    lists (plane, line, event count) for reading the trace by hand."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    intervals = []
    kernels = defaultdict(float)
    lines = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines.append((plane.name, line.name, len(events)))
            if not line.name.startswith("Stream"):
                continue
            for e in events:
                intervals.append((e.start_ns, e.end_ns))
                kernels[e.name] += e.duration_ns
    if not intervals:
        raise RuntimeError(f"no kernel events on a GPU stream line: {lines}")
    busy = _union_length(intervals) / steps / 1e9
    per_step = {k: v / steps / 1e9 for k, v in kernels.items()}
    return busy, per_step, lines


def classify(name: str) -> str:
    n = name.lower()
    if any(s in n for s in ("gemm", "cublas", "cutlass", "xmma", "sm90")):
        return "matmul library"
    if "nccl" in n or "all-reduce" in n or "all_reduce" in n:
        return "collective"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copy"
    if "fusion" in n or "reduce" in n or "convert" in n:
        return "XLA fusion"
    return "other"


def build_step(args):
    """(step, state) for the requested workload, jitted as the trainer and
    bench.py jit theirs."""
    import cmcd_tpu
    from cmcd_tpu import bounds
    from cmcd_tpu.utils import const_hoisted_jit
    from bench import _train_step_factory

    target = cmcd_tpu.load_target(args.target)
    setup = bounds.CMCDSetup(
        mode=args.mode, dim=target.dim, nbridges=args.nbridges,
        emb_dim=args.emb_dim, grad_clipping=True, nn_arch=args.nn_arch,
    )
    trainable = cmcd_tpu.default_trainable(setup.mode)
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=0.01, init_sigma=1.0,
        trainable=trainable,
    )
    if args.eval:
        def step(state):
            key, acc = state
            key, sk = jax.random.split(key)
            ne, _ = bounds.compute_elbos(params, sk, args.n, ctx, setup)
            return key, acc + jnp.mean(ne)

        state = (jax.random.PRNGKey(0), jnp.float32(0.0))
        return const_hoisted_jit(step, state), state

    loss_fn = bounds.loss_fn_for_mode(setup.mode)
    train_step, opt = _train_step_factory(
        lambda p, k: loss_fn(p, k, args.n, ctx, setup), trainable
    )
    state = (params["train"], params["notrain"], opt.init(params["train"]),
             jax.random.PRNGKey(0))
    return const_hoisted_jit(train_step, state), state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("target", type=str)
    ap.add_argument("--mode", type=str, default="MCD_CAIS_sn")
    ap.add_argument("--nbridges", type=int, default=8)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--emb_dim", type=int, default=20)
    ap.add_argument("--nn_arch", type=str, default="geffner")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--eval", action="store_true",
                    help="profile one evaluation forward pass, not a train step")
    ap.add_argument("--trace_dir", type=str, default=None,
                    help="keep the trace here (default: a temporary directory)")
    ap.add_argument("--json", type=str, default=None,
                    help="append the summary as one JSON line to this file")
    args = ap.parse_args(argv)

    from cmcd_tpu.utils.compile_cache import enable_compile_cache
    from cmcd_tpu.utils.profiling import device_summary

    enable_compile_cache()
    device = device_summary()
    if device["platform"] != "gpu":
        raise SystemExit(f"profile_step reads GPU stream lines; JAX found {device}")
    step, state = build_step(args)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        walls = run_traced(step, state, args.steps, args.trace_dir)
        busy, per_step, lines = parse_trace(args.trace_dir, args.steps)
    else:
        with tempfile.TemporaryDirectory() as td:
            walls = run_traced(step, state, args.steps, td)
            busy, per_step, lines = parse_trace(td, args.steps)
    summary = report(args, device, walls, busy, per_step, lines)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return summary


def report(args, device, walls, busy, per_step, lines):
    untraced, wall = walls
    what = "eval" if args.eval else f"train {args.mode}"
    idle = 1.0 - busy / wall
    kernels = sum(n for _, l, n in lines if l.startswith("Stream")) / args.steps
    print(f"\n{args.target} {what} K={args.nbridges} N={args.n} "
          f"emb_dim={args.emb_dim} {args.nn_arch} on {device['kind']}: "
          f"untraced wall {untraced*1e3:.3f} ms/step, traced wall "
          f"{wall*1e3:.3f} ms/step, device busy {busy*1e3:.3f} ms/step, "
          f"idle share (traced window) {idle:.4f}, busy/untraced wall "
          f"{busy/untraced:.4f}, {kernels:.0f} kernels/step")
    cats = defaultdict(float)
    for name, sec in per_step.items():
        cats[classify(name)] += sec
    for c, sec in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {c:<16} {sec*1e3:9.3f} ms/step")
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:12]
    print("  top kernels:")
    for name, sec in top:
        print(f"    {sec*1e3:9.3f} ms  {name[:90]}")
    print("  trace lines:", [f"{p}/{l}: {n}" for p, l, n in lines][:12])
    return {
        "target": args.target, "workload": what, "nbridges": args.nbridges,
        "n": args.n, "emb_dim": args.emb_dim, "nn_arch": args.nn_arch,
        "device": device, "untraced_wall_ms": untraced * 1e3,
        "traced_wall_ms": wall * 1e3, "busy_ms": busy * 1e3,
        "idle_share": idle, "kernels_per_step": kernels,
        "by_class_ms": {c: s * 1e3 for c, s in cats.items()},
        "top_kernels_ms": {n: s * 1e3 for n, s in top},
    }


if __name__ == "__main__":
    main()
