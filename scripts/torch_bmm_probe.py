#!/usr/bin/env python3
"""Whether the factored tier's products may batch seeds on the card.

    python scripts/torch_bmm_probe.py

At the headline's block shapes (C = 10 classes, H = 1000 models, G = 256
grid points, B items a block) it compares one replica's two table
products — ``eq (C, B, H) @ dlogcdf (C, H, G)`` and ``wE (C, B, G) @ F^T
(C, G, H)`` — against the same replica inside a batch of S (the
``(S, C, ...)`` batched product), bitwise, and times both forms with CUDA
events (medians of 10); then the pi-hat contraction ``hcs,hns->nc`` one
replica at a time against the batched ``xhcs,hns->xnc``; then one block's
product in fp32 (``eig_precision`` highest and high), one TF32 pass
(default) and three TF32 passes over hi/lo splits (the form ``high``
does not take: slower and less accurate than fp32 here), with each one's
largest error against float64. Prints the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    C, H, G, N = 10, 1000, 256, 50_000

    def ms(fn, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    for B in (256, 848, 1024, 2048):
        A = (torch.rand(C, B, H, device=dev, generator=g) < 0.1).float()
        W = torch.rand(C, B, G, device=dev, generator=g)
        T = torch.randn(C, H, G, device=dev, generator=g)
        F = torch.rand(C, H, G, device=dev, generator=g)
        for S in (3, 5):
            T5 = torch.randn(S, C, H, G, device=dev, generator=g)
            F5 = torch.rand(S, C, H, G, device=dev, generator=g)
            W5 = torch.rand(S, C, B, G, device=dev, generator=g)
            T5[0], F5[0], W5[0] = T, F, W
            same1 = torch.equal(A @ T, (A @ T5)[0])
            same2 = torch.equal(W @ F.transpose(-1, -2),
                                (W5 @ F5.transpose(-1, -2))[0])
            print(f"B={B} S={S}: replica 0 of the batch == one replica: "
                  f"eq@dlogcdf {same1}, wE@F^T {same2}; ms one replica "
                  f"{ms(lambda: A @ T):.3f}, {S} replicas batched "
                  f"{ms(lambda: A @ T5):.3f}")
    d = torch.rand(H, C, C, device=dev, generator=g)
    p = torch.rand(H, N, C, device=dev, generator=g)
    d5 = torch.rand(5, H, C, C, device=dev, generator=g)
    d5[0] = d
    one = torch.einsum("hcs,hns->nc", d, p)
    batched = torch.einsum("xhcs,hns->xnc", d5, p)[0]
    alone = torch.einsum("hcs,hns->nc", d5[0], p)
    print("pi-hat contraction: replica 0 of the batched einsum == one "
          f"replica: {torch.equal(one, batched)}; one replica at a time: "
          f"{torch.equal(one, alone)}")

    A = torch.randn(C, 1024, H, device=dev, generator=g)
    T = torch.randn(C, H, G, device=dev, generator=g)
    ref = A.double() @ T.double()

    def split(x):
        hi = (x.view(torch.int32) & -8192).view(torch.float32)
        return hi, x - hi

    def tf32(fn):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    ah, al = split(A)
    th, tl = split(T)
    forms = (("fp32 (highest, high)", lambda: A @ T),
             ("1xTF32 (default)", lambda: tf32(lambda: A @ T)),
             ("3xTF32 (not taken)",
              lambda: tf32(lambda: ah @ th + (ah @ tl + al @ th))))
    for name, fn in forms:
        err = float((fn().double() - ref).abs().max())
        print(f"{name}: {ms(fn):.4f} ms a (10, 1024, 1000) x (10, 1000, "
              f"256) product, max error vs float64 {err:.3e}")
    print(f"allow_tf32 after: {torch.backends.cuda.matmul.allow_tf32}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
