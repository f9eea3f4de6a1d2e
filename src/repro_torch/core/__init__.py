"""dMT-CGRA inter-thread communication, the paper's contribution, in PyTorch.

Counterpart of ``repro.core`` on one device.  Public API:
  from_thread_or_const / from_thread_or_const_nd / tag_value  (elevator node)
  from_thread_or_mem                                          (eLDST)
  plan_cascade / CascadePlan                                  (§4.3 cascades)
  SegmentMonoid / ELEMENTWISE / DIAG_STATE                    (composition law)
  linear_scan / chunked_linear_scan / device_linear_scan_carry
  device_shift / halo_exchange / ring_pass / seq_carry_scan   (mesh elevators)
  pipeline_apply                                              (PP forwarding)
  stage_through_memory / barrier / SharedBuffer               (vN baseline)
  cost_model                                                  (Fig. 11/12 bytes)

The device-space names run single-controller over the shards of a mesh
axis (:mod:`repro_torch.launch.mesh`): each takes and returns the list of
per-shard tensors, and a hop is a ``.to(device)`` of one shard's value.
"""

from repro_torch.core import cost_model
from repro_torch.core.chunk_scan import (
    DIAG_STATE,
    ELEMENTWISE,
    SegmentMonoid,
    chunked_linear_scan,
    device_linear_scan_carry,
    linear_scan,
)
from repro_torch.core.device_comm import (
    device_shift,
    halo_exchange,
    ring_pass,
    seq_carry_scan,
)
from repro_torch.core.eldst import ForwardStats, forward_stats, from_thread_or_mem
from repro_torch.core.elevator import (
    TOKEN_BUFFER_SIZE,
    CascadePlan,
    cascaded_from_thread_or_const,
    from_thread_or_const,
    from_thread_or_const_nd,
    plan_cascade,
    tag_value,
)
from repro_torch.core.pipeline import pipeline_apply
from repro_torch.core.scratchpad import SharedBuffer, barrier, stage_through_memory

__all__ = [
    "TOKEN_BUFFER_SIZE",
    "CascadePlan",
    "cascaded_from_thread_or_const",
    "from_thread_or_const",
    "from_thread_or_const_nd",
    "plan_cascade",
    "tag_value",
    "ForwardStats",
    "forward_stats",
    "from_thread_or_mem",
    "DIAG_STATE",
    "ELEMENTWISE",
    "SegmentMonoid",
    "chunked_linear_scan",
    "device_linear_scan_carry",
    "linear_scan",
    "device_shift",
    "halo_exchange",
    "ring_pass",
    "seq_carry_scan",
    "pipeline_apply",
    "SharedBuffer",
    "barrier",
    "stage_through_memory",
    "cost_model",
]
