#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, check it, time it.

    python3 chip_smoke.py

Phases, in order; the script exits non-zero at the first failure:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, the TF32 flags (both set False), and the kernel build;
  2. kernels: every kernel of the path against its plain PyTorch version
     on the card at the path's shapes, with times for the kernel, the
     plain version and the PyTorch library call computing the same
     function (a yardstick only; the port never calls it);
  3. slice: the full-width `paper-drl-trunk` policy served through
     ServeEngine for cartpole and pendulum at 500 and 2000 offered
     requests/s, with a hot swap in every cell; the kernel's launch count
     over that run must be 4 (one per layer) per dispatch;
  4. CLI: `repro_torch.launch.serve_policy --train-iters 0 --quick`.
It then prints the kernels' JSON line and, last, the device line.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,     # CUDA-core f32, H100 SXM data sheet
            "bfloat16": 989e12}   # dense bf16 tensor cores
SERVE_CASE = (32, 4, 2, 4, 64, True, 0)  # B, H, KVH, S, D, causal, window
KERNEL_CASES = [SERVE_CASE,
                (2, 4, 2, 384, 64, True, 0),
                (1, 4, 1, 256, 64, True, 64),
                (2, 2, 2, 96, 32, False, 0),
                (1, 2, 1, 512, 256, True, 0)]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_time_ms(fn, iters, warmup=10):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attended_pairs(S, causal, window):
    """(query, key) pairs the masks keep: the work these inputs need."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window else 0
        hi = q + 1 if causal else S
        total += max(0, hi - lo)
    return total


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"tf32: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels.common import build_kernels, load_kernels
    t0 = time.perf_counter()
    lib, log = build_kernels()
    load_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s -> "
          f"{os.path.relpath(lib, ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    return card


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    cases = [(c, "float32") for c in KERNEL_CASES] + [(SERVE_CASE,
                                                      "bfloat16")]
    for (B, H, KVH, S, D, causal, window), dname in cases:
        dt = getattr(torch, dname)
        G = H // KVH
        qg = torch.randn((B, S, KVH, G, D), generator=gen,
                         device="cuda").to(dt)
        k = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(dt)
        q_hsd = qg.reshape(B, S, H, D).transpose(1, 2)
        k_hsd, v_hsd = k.transpose(1, 2), v.transpose(1, 2)

        def kernel():
            return flash_attention(qg, k, v, causal=causal, window=window)

        def plain():
            return attention_ref(q_hsd, k_hsd, v_hsd, causal=causal,
                                 window=window)

        mask = None
        if window:
            qi = torch.arange(S, device="cuda")[:, None]
            ki = torch.arange(S, device="cuda")[None, :]
            mask = (ki <= qi) & (ki > qi - window)
        qc, kc, vc = (t.contiguous() for t in (q_hsd, k_hsd, v_hsd))

        def library():
            return F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True)

        out = kernel()
        torch.cuda.synchronize()
        ref = plain().transpose(1, 2).reshape(B, S, KVH, G, D)
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item(),
              f"flash_attention non-finite at {(B, H, KVH, S, D)}")
        check(err <= TOL[dname],
              f"flash_attention {dname} {(B, H, KVH, S, D, causal, window)}"
              f" max_abs_err {err} > {TOL[dname]}")
        iters = 200 if S <= 128 else 50
        ms = cuda_time_ms(kernel, iters)
        plain_ms = cuda_time_ms(plain, iters)
        library_ms = cuda_time_ms(library, iters)
        es = torch.finfo(dt).bits // 8
        nbytes = es * (2 * B * H * S * D + 2 * B * KVH * S * D)
        ops = 4 * D * B * H * attended_pairs(S, causal, window)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / PEAK_OPS[dname]
        row = {"shape": [B, H, KVH, S, D], "causal": causal,
               "window": window, "dtype": dname, "max_abs_err": err,
               "tol": TOL[dname], "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        print("kernel_case " + json.dumps(row))
        results[((B, H, KVH, S, D, causal, window), dname)] = row
    print("kernels_checked " + json.dumps({"kernels": ["flash_attention_hsd"]}))
    return results


def phase_slice(card):
    import numpy as np
    import torch
    import repro_torch.envs as envs
    from repro_torch.core.networks import TrunkPolicy
    from repro_torch.core.serving import ParamStore, ServeEngine
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_hsd
    from repro_torch.launch.serve_policy import run_offered_load

    runs = []
    flash_attention_hsd.launches = 0
    for name in ("cartpole", "pendulum"):
        spec = envs.make(name).spec
        policy = TrunkPolicy.for_spec(spec, reduced=False)
        check(policy.lm.cfg.d_model == 256 and policy.lm.cfg.n_layers == 4
              and policy.lm.cfg.n_kv_heads == 2, "not the full-width trunk")
        params = policy.init(torch.Generator().manual_seed(0))
        swap = {k: v * (1 + 1e-3) for k, v in params.items()}
        obs_rows = spec.observation.sample(
            torch.Generator().manual_seed(1), 160).numpy()
        for buckets in ((1, 4, 16), (8, 32)):
            store = ParamStore()
            store.publish(params)
            engine = ServeEngine(policy, spec.observation, buckets=buckets,
                                 store=store, seed=0)
            warm = engine.warmup()
            cells = [run_offered_load(engine, obs_rows, load, 160,
                                      swap_params=swap)
                     for load in (500.0, 2000.0)]
            check(engine.compile_count == warm,
                  f"{name} {buckets}: compile_count rose after warmup "
                  f"({warm} -> {engine.compile_count})")
            runs.append((name, buckets, policy, params, engine, obs_rows,
                         cells))
    launches = flash_attention_hsd.launches
    dispatches = sum(r[4].stats["batches"] for r in runs)
    n_layers = 4
    check(launches >= n_layers * dispatches > 0,
          f"flash_attention_hsd launched {launches} times over "
          f"{dispatches} dispatches; expected {n_layers} per dispatch")
    print(f"slice: {dispatches} dispatches, flash_attention_hsd launches "
          f"{launches} ({launches / dispatches:g} per dispatch)")

    # checks below launch the kernel again; they are not the main path
    for name, buckets, policy, params, engine, obs_rows, cells in runs:
        space = envs.make(name).spec.action
        for r in engine.results.values():
            check(math.isfinite(r["logp"]) and math.isfinite(r["value"]),
                  f"{name}: non-finite response {r}")
            check(space.contains(np.asarray(r["action"])),
                  f"{name}: action {r['action']} outside {space}")
        check(all(c["versions"] >= 2 and c["hot_swaps"] == 1 for c in cells),
              f"{name} {buckets}: hot swap not served")
        b = buckets[-1]
        _, cur = engine.store.get()
        a_b, l_b, v_b = engine.eval_bucket(list(obs_rows[:5]), range(5), b,
                                           params=cur)
        for i in range(5):
            a1, l1, v1 = engine.eval_bucket([obs_rows[i]], [i], b,
                                            params=cur)
            check(torch.equal(a_b[i], a1[0]) and torch.equal(l_b[i], l1[0])
                  and torch.equal(v_b[i], v1[0]),
                  f"{name} bucket {b}: row {i} not bitwise per-request")
        for c in cells:
            print("slice_cell " + json.dumps(dict(
                c, env=name, buckets="-".join(map(str, buckets)),
                card=card)))
    for name in ("cartpole", "pendulum"):
        run = next(r for r in runs if r[0] == name)
        policy, params, obs_rows = run[2], run[3], run[5]
        plain = TrunkPolicy.for_spec(envs.make(name).spec, reduced=False,
                                     use_kernels=False)
        obs = torch.as_tensor(obs_rows[:32], device="cuda")
        with torch.inference_mode():
            pk, vk = policy.apply(params, obs)
            pr, vr = plain.apply(params, obs)
        err = max((pk - pr).abs().max().item(), (vk - vr).abs().max().item())
        check(err <= 1e-4, f"{name}: kernel path vs use_kernels=False "
                           f"max_abs_err {err} > 1e-4")
        print(f"slice {name}: kernel path vs use_kernels=False "
              f"max_abs_err {err:.3e}")
    return launches


def phase_cli():
    from repro_torch.launch.serve_policy import main as serve_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_main(["--train-iters", "0", "--quick"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(out["recompiles_after_warmup"] == 0 and out["hot_swaps"] == 4
          and out["device"].startswith("cuda"), f"CLI summary {out}")
    print("cli " + json.dumps(out))


def main():
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    card = phase_device()
    cases = phase_kernels()
    launches = phase_slice(card)
    phase_cli()
    serve = cases[(SERVE_CASE, "float32")]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_hsd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
        "launches": launches, "max_abs_err": serve["max_abs_err"],
        "ms": serve["ms"], "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
