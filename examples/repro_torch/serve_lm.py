"""Batched serving example (the survey's Actor/inference path; the port
of examples/serve_lm.py): prefill a prompt batch, then decode with
per-layer KV/recurrent caches — including the sub-quadratic paths (rwkv6
state, gemma3 sliding-window ring cache).

  PYTHONPATH=src python examples/repro_torch/serve_lm.py \
      --arch rwkv6-1.6b [--device cpu]
"""
import argparse
import json

from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    out = serve(args.arch, reduced=True, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                device=args.device)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
