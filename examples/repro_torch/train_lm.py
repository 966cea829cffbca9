"""End-to-end LM training driver example (the port of
examples/train_lm.py): train a reduced assigned architecture for a few
hundred steps and verify the loss approaches the synthetic stream's
entropy floor.

  PYTHONPATH=src python examples/repro_torch/train_lm.py \
      --arch smollm-360m --steps 300 [--device cpu]

Any of the 10 assigned architectures works via --arch (see
`python -c "from repro_torch.configs import list_archs; print(list_archs())"`).
The params are written to experiments/ckpt_torch_<arch>.npz in the
reference's archive layout.
"""
import argparse

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (needs the card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    out = train(args.arch, reduced=not args.full, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt="experiments/ckpt_torch_" + args.arch,
                device=args.device)
    print(f"params={out['n_params']:,} "
          f"final_ce={out['history'][-1]['ce']} "
          f"entropy_floor={out['optimal_ce']}")


if __name__ == "__main__":
    main()
