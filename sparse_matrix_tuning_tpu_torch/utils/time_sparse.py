"""Time K1 (block_grad) and K5 (block_correction) through their public
wrappers at the main path's shapes, on one CUDA GPU:

    python sparse_matrix_tuning_tpu_torch/utils/time_sparse.py [--root DIR] [--n 24,7,2]

K1 at run A's T = 2048 (bs 4 x seq 512) on the gate/up (5632 x 2048) and
q (2048 x 2048) weights; K5 at run E's gate/up forward (T 2048, D^T) and
grad_input (T 2048, D), and at run F3's decode rows (T 64, gate/up
forward); each at every n of `--n` (blocks per linear), with seeded block
coordinates that repeat rows, columns and one pair. Each time is one call
alone with its inputs evicted from L2, the median of 20 (chip_smoke.py's
`time_ms`, loaded from this checkout), beside its bound, a library
call's time and its plain version's (host time, synchronised). `--root`: the
checkout whose `sparse_matrix_tuning_tpu_torch` is timed (default this
one), so that two trees can be timed in turns with one script (the
wrappers' signatures have not changed since they were first ported). Prints
one line per case, the card's name and power limit, and a JSON line.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    # run by path, its own directory leads sys.path, and its logging.py would
    # shadow the standard library's
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

import argparse
import importlib.util
import json
import shutil
import subprocess
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]

K1_CASES = (("gate/up", 2048, 5632, 2048), ("q", 2048, 2048, 2048))  # (what, T, O, I)
# (what, T, out width, src width, transpose)
K5_CASES = (("E gate/up forward", 2048, 5632, 2048, True),
            ("E gate/up grad_input", 2048, 2048, 5632, False),
            ("F3 decode gate/up forward", 64, 5632, 2048, True))


def _coords(rng, n, n_row, n_col):
    """n block coordinates; from n >= 4 on, a repeated row, a repeated
    column and a repeated pair (chip_smoke.py's `_coords`)."""
    import numpy as np
    rb = rng.integers(0, n_row, n).astype(np.int32)
    cb = rng.integers(0, n_col, n).astype(np.int32)
    if n >= 4:
        rb[1] = rb[0]
        cb[2] = cb[0]
        rb[3], cb[3] = rb[0], cb[0]
    return rb, cb


def time_cases(n_values, time_ms, bound, log=print, seed=0, k1_plans=(), k5_plans=()):
    """K1 and K5 at every case and n, each beside one PyTorch call that
    computes the same (bmm on the gathered panels; for K5 then index_add_)
    and its plain version; returns a list of dicts (kernel, what, shape, n,
    runs, ms, library_ms, plain_wall_ms, bound_ms, bound_by). k1_plans / k5_plans: forced
    launch plans (bm, splits) / (bm, bn), each timed too, under "by_plan"
    (the redesigned wrappers only)."""
    import numpy as np
    import torch
    from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
    from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    rows = []
    for what, t, o, i in K1_CASES:
        g2, x2 = randn(t, o), randn(t, i)
        for n in n_values:
            rb_np, cb_np = _coords(rng, n, o // 256, i // 256)
            rb, cb = torch.from_numpy(rb_np).to(dev), torch.from_numpy(cb_np).to(dev)
            ms = time_ms(lambda: k1.block_grad(g2, x2, rb, cb))

            def lib():  # bmm on the gathered bf16 panels
                g_rows = g2.reshape(t, -1, 256).index_select(1, rb.long()).transpose(0, 1)
                x_cols = x2.reshape(t, -1, 256).index_select(1, cb.long()).transpose(0, 1)
                return torch.bmm(g_rows.transpose(1, 2), x_cols)

            nbytes = (len(set(rb_np)) + len(set(cb_np))) * t * 256 * 2 + n * 65536 * 4
            bnd = bound(nbytes, 2.0 * n * t * 65536, "bf16")
            rows.append(dict(kernel="K1 block_grad", what=what, shape=f"T={t} (O,I)=({o},{i})",
                             n=n, runs=None, ms=ms, library_ms=time_ms(lib),
                             plain_wall_ms=_wall_ms(lambda: k1.block_grad_plain(g2, x2, rb, cb)),
                             bound_ms=bnd[0], bound_by=bnd[1]))
            if k1_plans:
                rows[-1]["by_plan"] = {
                    f"{bm}x256/{sp}": time_ms(lambda: k1._launch(g2, x2, rb, cb, bm, sp))
                    for bm, sp in k1_plans}
    for what, t, o, i, transpose in K5_CASES:
        out, src = randn(t, o), randn(t, i)
        for n in n_values:
            delta = randn(n, 256, 256, scale=0.02)
            io, ii = _coords(rng, n, o // 256, i // 256)
            sched = k5.correction_schedule(io, ii, dev)
            ms = time_ms(lambda: k5.block_correction(out, src, delta, sched, transpose))
            io_t = torch.from_numpy(io).long().to(dev)
            ii_t = torch.from_numpy(ii).long().to(dev)

            def lib():  # bmm on the gathered panels, then index_add_
                panels = src.reshape(t, -1, 256).index_select(1, ii_t).transpose(0, 1)
                corr = torch.bmm(panels, delta.transpose(1, 2) if transpose else delta)
                out.view(t, -1, 256).index_add_(1, io_t, corr.transpose(0, 1))

            nbytes = (2 * len(set(io)) + len(set(ii))) * t * 256 * 2 + n * 65536 * 2
            bnd = bound(nbytes, 2.0 * n * t * 65536, "bf16")
            rows.append(dict(kernel="K5 block_correction", what=what,
                             shape=f"T={t} out {o} src {i} {'D^T' if transpose else 'D'}",
                             n=n, runs=sched.n_runs, ms=ms, library_ms=time_ms(lib),
                             plain_wall_ms=_wall_ms(lambda: k5.block_correction_plain(
                                 out, src, delta, io, ii, transpose)),
                             bound_ms=bnd[0], bound_by=bnd[1]))
            if k5_plans:
                rows[-1]["by_plan"] = {
                    f"{bm}x{bn}": time_ms(
                        lambda: k5._launch(out, src, delta, sched, transpose, bm, bn))
                    for bm, bn in k5_plans}
    for r in rows:
        runs = "" if r["runs"] is None else f", {r['runs']} runs"
        by_plan = "".join(f"; {k} {v:.4f}" for k, v in r.get("by_plan", {}).items())
        log(f"[time_sparse] {r['kernel']} {r['what']} {r['shape']} n={r['n']}{runs}: "
            f"{r['ms']:.4f} ms, library {r['library_ms']:.4f} ms, plain {r['plain_wall_ms']:.4f} "
            f"ms (wall), bound {r['bound_ms']:.3e} ms ({r['bound_by']}){by_plan}")
    return rows


def _wall_ms(fn, reps=10):
    """Host time of one call, synchronised, over `reps` calls: the plain
    versions launch many small kernels (a few a block for K5), and at
    small n the card finishes each before the host has queued the next, so
    their device time alone (`time_ms`) is not theirs to measure."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_smoke_timing", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose sparse_matrix_tuning_tpu_torch is timed")
    ap.add_argument("--n", default="24", help="comma-separated blocks per linear")
    ap.add_argument("--plans", action="store_true",
                    help="also time chip_smoke.py's forced launch plans (K1_PLANS, K5_PLANS; "
                    "the redesigned wrappers only)")
    args = ap.parse_args(argv)
    smoke = _chip_smoke()
    smoke.check_device()  # raises without a card
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree under {root}")
    _build.load()
    plans = (smoke.K1_PLANS, smoke.K5_PLANS) if args.plans else ((), ())
    rows = time_cases([int(v) for v in args.n.split(",")], smoke.time_ms, smoke.bound,
                      k1_plans=plans[0], k5_plans=plans[1])
    smi = shutil.which("nvidia-smi")
    card = None
    if smi:
        card = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "card": card, "times": rows}), flush=True)


if __name__ == "__main__":
    main()
