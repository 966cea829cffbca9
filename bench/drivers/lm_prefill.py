"""The LM-prefill driver: `LanguageModel.prefill` and the first token, one
request at a time (batch 1, a closed loop, one client).

Set-up builds the model, makes the weights on the card from the seed,
draws every request's prompt, and prefills the shortest and the longest
prompt once each. The window then sends request after request: each
prefills its prompt, takes the first token as the launcher does
(`launch/serve._next_token`, greedy) and reads it on the host, which ends
its time to first token. The window closes with the first round of
requests that ends `--seconds` or more after it opened. `--trace 1` then
traces one more round of requests.

Prompt lengths are a fixed set of quantiles of a log-uniform law, cut
into strata of consecutive quantiles; each round sends one prompt of
every stratum, in an order drawn from the seed, and round r the same
members whatever the seed, so that a window carries the same lengths
whatever the seed. The token ids are drawn from the seed.

Once the window has closed and the peak memory is read, a sample of the
finished requests drawn from the seed, the longest among them, is run
through the float32 reference. Each request's gap is the larger of its
largest logit error and its served token's shortfall below the
reference's best, in units of the reference logits' std; the check
compares the median request's gap. (A float32 rounding that flips one
near-tied top-k routing choice moves a request's logits by 1e-4 to 0.1
std, on about one request in ten; TF32 products move nearly every
request by 0.01 to 0.7 std.)
"""
from __future__ import annotations

import random
import statistics
import time

import torch

from bench import counting, harness, weights
from bench.drivers.rl_train import program_config
from bench.refs import transformer as ref
from bench.trace import Spans, traced

ROUNDS = 256        # rounds of requests drawn; a window uses a few of them


def lengths(traffic):
    """The fixed set of prompt lengths: quantiles (i + 1/2) / n of a
    log-uniform law on [min_len, max_len], in ascending order."""
    lo, hi, n = traffic["min_len"], traffic["max_len"], traffic["n_lengths"]
    return [round(lo * (hi / lo) ** ((i + 0.5) / n)) for i in range(n)]


def spread_order(n):
    """range(n) in van der Corput order (0, 4, 2, 6, 1, 5, 3, 7 for 8), so
    that every run of consecutive rounds takes a stratum's members evenly."""
    def radical(i):
        x, f = 0.0, 0.5
        while i:
            x += f * (i & 1)
            i >>= 1
            f /= 2
        return x
    return sorted(range(n), key=radical)


def schedule(traffic, seed, rounds=ROUNDS):
    """The requests' prompt lengths in order: round after round, each one
    prompt of every stratum, the strata in an order drawn from the seed.
    Round r takes member `spread_order[r % per]` of every stratum, so any
    seed sends the same lengths in the same rounds, in another order."""
    ls = lengths(traffic)
    k = traffic["strata"]
    per = len(ls) // k
    members = spread_order(per)
    rng = random.Random(seed)
    out = []
    for r in range(rounds):
        order = list(range(k))
        rng.shuffle(order)
        out.extend(ls[s * per + members[r % per]] for s in order)
    return out


class Prompts:
    """Every request's token ids, drawn on the device in one call."""

    def __init__(self, lens, vocab, seed, device):
        self.starts = [0]
        for n in lens:
            self.starts.append(self.starts[-1] + n)
        gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        self.ids = torch.randint(0, vocab, (self.starts[-1],),
                                 generator=gen, device=device)

    def __getitem__(self, i):
        return self.ids[self.starts[i]:self.starts[i + 1]][None]


class Run:
    def __init__(self, cell, seed, device):
        from repro_torch.launch.serve import _next_token
        from repro_torch.models.model import ModelOpts, build_model
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.rcfg = ref.with_head_dim(cell.config)
        self.model = build_model(program_config(cell.config), ModelOpts(
            dtype=cell.config["dtype"], remat=False,
            use_kernels=cell.config["use_kernels"]))
        self.next_token = _next_token
        self.params = weights.draw(weights.program_shapes(self.model), seed,
                                   self.device)
        self.order = schedule(cell.traffic, seed)
        self.prompts = Prompts(self.order, cell.config["vocab"], seed,
                               self.device)
        self.served = []     # (request, ttft s, first token, logits (V,))
        self.next = 0

    def request(self, keep=True):
        """One request: prefill, the first token on the host."""
        i = self.next
        self.next += 1
        tokens = self.prompts[i]
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, cache = self.model.prefill(self.params, tokens)
            tok = self.next_token(logits, 0.0, None)
            first = int(tok[0, 0])
        ttft = time.perf_counter() - t0
        del cache
        if keep:
            self.served.append((i, ttft, first, logits[0, -1]))

    def warm(self):
        """The shortest and the longest prompt once each (set-up)."""
        ls = lengths(self.cell.traffic)
        for n in (ls[0], ls[-1]):
            tokens = self.prompts.ids[:n][None]
            with torch.inference_mode():
                logits, cache = self.model.prefill(self.params, tokens)
                int(self.next_token(logits, 0.0, None)[0, 0])
            del cache, logits

    def window(self, seconds):
        """Requests from the first of a round until the end of the first
        round that ends `seconds` or more after the window opened, so that
        every seed's window holds whole rounds: the same lengths."""
        k = self.cell.traffic["strata"]
        t0 = time.perf_counter()
        while True:
            self.request()
            now = time.perf_counter()
            if now - t0 >= seconds and self.next % k == 0:
                return now - t0

    def sample(self):
        """The finished requests the check compares: the longest, then
        others drawn from the seed."""
        n = self.cell.traffic["checked"]
        idx = list(range(len(self.served)))
        longest = max(idx, key=lambda j: (self.order[self.served[j][0]], -j))
        rest = [j for j in idx if j != longest]
        random.Random(self.seed + 7).shuffle(rest)
        return [longest] + rest[:n - 1]


def logit_gap(got, want, token):
    """The widest gap of one request, in units of the reference logits'
    std: the largest logit error, or how far the served token's reference
    logit lies below the reference's best, whichever is larger."""
    sd = float(want.std())
    err = float((got - want).abs().max())
    short = float(want.max() - want[token])
    return max(err, short) / sd


def gaps(run, picks, precision="float32"):
    """[(prompt length, logit gap)] of the picked requests; `precision`
    other than float32 puts the reference in that precision in the
    program's place (the control)."""
    out = []
    for j in picks:
        i, _, token, logits = run.served[j]
        want = ref.last_logits(run.params, run.prompts[i], run.rcfg)
        if precision != "float32":
            logits = ref.last_logits(run.params, run.prompts[i], run.rcfg,
                                     precision)
            token = int(logits.argmax())
        out.append((run.order[i], logit_gap(logits.float(), want, token)))
    return out


def run(cell, seed, seconds, trace, device, t_start):
    if device == "cuda":
        ref.set_plain_precision()
    r = Run(cell, seed, device)
    r.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    window_s = r.window(seconds)
    done = list(r.served)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    reading, metrics, states = None, [], {}
    if trace:
        metrics = cell.metrics()
        spans = Spans()
        states = harness.install_spans(spans, metrics)
        k = cell.traffic["strata"]
        with spans:
            reading, _ = traced(spans, lambda: [r.request(keep=False)
                                                for _ in range(k)])
    toks = sum(r.order[i] for i, *_ in done)
    flops = sum(counting.prefill_flops(r.rcfg, r.order[i]) for i, *_ in done)
    info = {"window_s": window_s, "window_flops": flops,
            "traced_requests": cell.traffic["strata"]}
    gap = statistics.median(g for _, g in gaps(r, r.sample()))
    checks, ok = harness.checks({"logit_gap_median": gap}, cell.limits)
    out = {"correct": ok, "attempted": len(done), "failed": 0}
    if trace:
        out["metrics"] = ({} if reading is None else
                          harness.read_metrics(metrics, reading, info,
                                               states))
    else:
        ttft = [t for _, t, _, _ in done]
        out["metrics"] = {
            "prefill_tok_per_s": {"value": toks / window_s,
                                  "unit": "tokens/s"},
            "ttft_p90_ms": {"value": harness.percentile(ttft, 90) * 1e3,
                            "unit": "ms"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    out["device"] = (harness.device_info(cell.chips, peak)
                     if device == "cuda" else
                     {"platform": "cpu", "count": 0, "memory_peak_bytes": 0})
    if reading is not None:
        out["device"]["busy_s"] = reading.busy_s
        out["device"]["window_s"] = reading.window_s
        out["breakdown"] = reading.breakdown()
    out["checks"] = checks
    return out

