"""Quickstart: the paper's primitives in PyTorch (the port of
``examples/quickstart.py``): the elevator node, the 1-D convolution, the
prefix sum, the eLDST shared load, a cascade, and the same elevator edge
across a seq mesh of 4 shards (the device-space elevator).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    device_shift,
    from_thread_or_const,
    from_thread_or_mem,
    linear_scan,
    plan_cascade,
    tag_value,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_seq_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    dev = resolve_device(ap.parse_args(argv).device)
    out = {}

    # fromThreadOrConst: thread t reads thread t-1's value (Fig. 1c).
    x = torch.arange(8.0, device=dev)
    out["left_neighbor"] = from_thread_or_const(x, delta=1, const=0.0)
    print("x:            ", x.tolist())
    print("x[t-1] or 0:  ", out["left_neighbor"].tolist())

    # 1D convolution exactly as the paper writes it (margins = constant C).
    kernel = torch.tensor([0.25, 0.5, 0.25], device=dev)
    out["conv"] = (from_thread_or_const(x, 1, 0.0) * kernel[0] + x * kernel[1]
                   + from_thread_or_const(x, -1, 0.0) * kernel[2])
    print("conv3:        ", out["conv"].tolist())

    # Prefix sum (Fig. 6): the elevator edge carries the running sum.
    out["sums"] = linear_scan(torch.ones_like(x), tag_value(x, "sum"))
    print("prefix sum:   ", out["sums"].tolist())

    # fromThreadOrMem: one thread loads, the others receive it (Fig. 2b).
    mem = torch.arange(10.0, 18.0, device=dev)   # the values each thread WOULD load
    pred = torch.arange(8, device=dev) % 4 == 0  # only threads 0 and 4 load
    out["shared_load"] = from_thread_or_mem(mem, pred, delta=1, window=4)
    print("loads issued: ", int(pred.sum()), "of", mem.shape[0])
    print("forwarded:    ", out["shared_load"].tolist())

    # Cascading (paper Fig. 10a): Δ=18 with 16-entry token buffers.
    out["plan"] = plan_cascade(18)
    print("cascade for Δ=18:", out["plan"].node_deltas, "spilled:", out["plan"].spilled)

    # The same edge across a mesh (device-space elevator): shard i receives
    # shard i-1's value, shard 0 the constant -1.  Four shards on one device.
    mesh = make_seq_mesh(4, device=dev)
    shards = [torch.tensor([float(i)], device=d) for i, d in enumerate(mesh.devices.flat)]
    out["device_shift"] = torch.cat([s.to(dev) for s in device_shift(shards, 1, fill=-1.0)])
    print("device-space elevator:", out["device_shift"].tolist())
    return out


if __name__ == "__main__":
    main()
