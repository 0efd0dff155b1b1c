"""Self-train the DROID update operator on synthetic flow (see
splatslam_tpu_torch/train/droid_trainer.py); the port's counterpart of the
repository's train_droid.py, with its flags and defaults plus --device:

    python -m splatslam_tpu_torch.train_droid --stage both --buckets both
    python -m splatslam_tpu_torch.train_droid --device cpu ...

Stage "flow"  -> pretrained/droid_selftrained.msgpack (flow supervision)
Stage "dba"   -> pretrained/droid_dba.msgpack (fine-tuned THROUGH the
                 differentiable BA layer; consumed by the tracker when
                 tracking.pretrained points at a .msgpack)
Stage "both"  -> flow then dba.

The files are written as the JAX package's trainer writes them, so either
package's tracker reads them. --buckets both trains at BOTH geometry
buckets (96x128/fx80 and 240x320/fx200 — FLOW_BUCKETS); the bench runs at
the latter, and a net trained only at 96x128 is near-blind there. --pool N
pre-renders N batches and cycles them so the host's renderer does not
starve the GPU. Runs on the GPU unless --device names another device; with
no GPU and no --device it raises.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("flow", "dba", "both"),
                    default="flow")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--dba-steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dba-batch", type=int, default=2,
                    help="batch for the dba stage (heavier: N-frame "
                         "sequences through the unrolled solver)")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--dba-lr", type=float, default=5e-5)
    ap.add_argument("--pool", type=int, default=0,
                    help="pre-render this many batches and cycle them")
    ap.add_argument("--buckets", choices=("small", "both"), default="both")
    ap.add_argument("--init", type=str, default=None,
                    help="continue the flow stage from this .msgpack "
                         "instead of random init")
    ap.add_argument("--out", type=str,
                    default="pretrained/droid_selftrained.msgpack")
    ap.add_argument("--dba-out", type=str,
                    default="pretrained/droid_dba.msgpack")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .train.droid_trainer import (FLOW_BUCKETS, load_selftrained, train,
                                      train_dba)

    device = resolve_device(args.device)
    buckets = FLOW_BUCKETS if args.buckets == "both" else None
    if args.stage in ("flow", "both"):
        init_params_flow = None
        if args.init:
            init_params_flow = load_selftrained(args.init, device=device)
            print(f"[train] flow stage continues from {args.init}")
        train(steps=args.steps, batch=args.batch, lr=args.lr,
              ckpt_path=args.out, buckets=buckets, pool=args.pool,
              params=init_params_flow, device=device)
    if args.stage in ("dba", "both"):
        train_dba(steps=args.dba_steps, batch=args.dba_batch, lr=args.dba_lr,
                  init_ckpt=args.out, ckpt_path=args.dba_out,
                  buckets=buckets, pool=args.pool, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
