"""``t2_att_step_kernel`` (``spoofsv_torch/csrc/t2_rollout.cu``) against its roofline, %.

Source: the device time of the operations whose name holds the kernel's
(``torch.profiler``) over the calls of the traced part of the window,
against the least time the card could take for its counted work
(``portbench/work/tacotron2.py``): its products with weights every row
shares at the bf16 tensor-core peak, the rest of its arithmetic at the f32
peak, or its bytes over the memory bandwidth where that is longer
(``kernel_bound_s``). None where the trace holds no such kernel, or on a
card the table of peaks lacks."""

from portbench import work
from portbench.work import tacotron2 as t2work

KERNEL = "t2_att_step_kernel"


def read(view):
    counted = view.extra.get("kernel_work", {}).get(KERNEL)
    device_s = sum(dur for name, _, dur, _ in view.device_ops if KERNEL in name) / 1e6
    table = work.peaks(view.extra.get("device_kind", ""))
    if not counted or not device_s or table is None:
        return None
    return 100.0 * view.extra["calls_traced"] * t2work.kernel_bound_s(counted, table) / device_s
