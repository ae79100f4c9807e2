"""Times ``kernels.gram.xty`` of the ``repro_torch`` on the path, on a card.

At the shapes the port's main paths give it: the dual fit's ``XXᵀ`` (a
contiguous ``Xᵀ``, as every version of the kernel takes it) and ``Xᵀα``
at whole_brain_mor (n 1,000, p 16,384, t 2,000), MOR's single-target
``Xᵀα`` (q = 1) and one parcels fold Gram (55,361 × 16,384, x is y), each
beside ``torch.matmul(x.T, y)`` (TF32 off), in turns (library, kernel,
kernel, library), CUDA-event means.  One JSON line per shape, with the
card's name and power limit.  It calls only ``gram.xty`` and ``ref.xty``,
so it runs on any version of the package.

    PYTHONPATH=<checkout>/src python3 tools/time_xty.py [label]

Run it on two checkouts in one call to compare them on one card (a kernel
that one of them no longer has can be timed only so).
"""
import json
import subprocess
import sys

import torch


def _ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time(label: str, card: str, name: str, x, y, reps: int) -> None:
    from repro_torch.kernels import gram, ref

    turns = [_ms(fn, reps) for fn in (
        lambda: torch.matmul(x.T, y), lambda: gram.xty(x, y),
        lambda: gram.xty(x, y), lambda: torch.matmul(x.T, y))]
    want = ref.xty(x, y)
    err = (gram.xty(x, y) - want).abs().max().item()
    print(json.dumps({"label": label, "shape": name, "x": list(x.shape),
                      "y": list(y.shape), "kernel_ms": turns[1:3],
                      "library_ms": [turns[0], turns[3]],
                      "max_abs_err": err,
                      "max_abs_plain": want.abs().max().item(),
                      "card": card}))


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("time_xty: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator("cuda").manual_seed(0)
    X = torch.randn(1_000, 16_384, device="cuda", generator=g)
    alpha = torch.randn(1_000, 2_000, device="cuda", generator=g)
    Xt = X.T.contiguous()
    for name, x, y, reps in (("XXt", Xt, Xt, 30), ("Xt.alpha", X, alpha, 30),
                             ("Xt.alpha q=1", X, alpha[:, :1].contiguous(),
                              30)):
        _time(label, card, name, x, y, reps)
    del X, alpha, Xt
    torch.cuda.empty_cache()
    x = torch.randn(55_361, 16_384, device="cuda", generator=g)
    _time(label, card, "fold Gram", x, x, 2)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ""))
