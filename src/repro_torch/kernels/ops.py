"""Public kernel entry points and the launch counters.

Port of ``repro.kernels.ops``: ``on_cuda()`` takes the place of
``on_tpu()``. Every wrapper runs its plain version on CPU tensors and its
CUDA kernel on CUDA tensors.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.cm.cm import (CM_SMEM_BUDGET_BYTES, cm_burst,
                                       cm_burst_batch_xt, cm_burst_pen_xt,
                                       cm_burst_xt, cm_epochs,
                                       cm_epochs_smem_ok, cm_smem_ok)
from repro_torch.kernels.cm.ref import (cm_burst_batch_ref, cm_burst_ref,
                                        cm_epochs_ref, cm_sweep_wide_ref)
from repro_torch.kernels.cm.wide import cm_sweep_wide, cm_wide_smem_ok
from repro_torch.kernels.fused.fused import chain_suffix_sums
from repro_torch.kernels.fused.ref import chain_suffix_sums_ref
from repro_torch.kernels.gram.gram import (gram_smem_ok, gram_sweep,
                                           gram_sweep_batch)
from repro_torch.kernels.group.group import group_bcd, group_smem_ok
from repro_torch.kernels.group.ref import group_bcd_ref
from repro_torch.kernels.gram.ref import gram_sweep_batch_ref, gram_sweep_ref
from repro_torch.kernels.screen.ref import (screen_fused_batch_ref,
                                            screen_fused_ref,
                                            screen_scores_ref,
                                            screen_tail_batch_ref,
                                            screen_tail_ref,
                                            ub_histogram_batch_ref,
                                            ub_histogram_ref)
from repro_torch.kernels.screen.screen import (screen_fused,
                                               screen_fused_batch,
                                               screen_scores, screen_tail,
                                               screen_tail_batch,
                                               ub_histogram,
                                               ub_histogram_batch)

# kernel name -> the wrapper whose ``launches`` counts it (K2's tail entries
# screen_tail and screen_tail_batch count in ub_histogram and
# ub_histogram_batch, as screen_scores counts in screen_fused)
KERNELS = {"screen_fused": screen_fused, "ub_histogram": ub_histogram,
           "cm_burst": cm_burst_xt, "cm_burst_pen": cm_burst_pen_xt,
           "chain_suffix_sums": chain_suffix_sums,
           "screen_fused_batch": screen_fused_batch,
           "ub_histogram_batch": ub_histogram_batch,
           "cm_burst_batch": cm_burst_batch_xt, "cm_epochs": cm_epochs,
           "gram_sweep": gram_sweep, "gram_sweep_batch": gram_sweep_batch,
           "cm_sweep_wide": cm_sweep_wide, "group_bcd": group_bcd,
           # K1 / K1b in the mixed mode (in_dtype / acc_dtype given)
           "screen_fused_mixed": screen_fused.mixed,
           "screen_fused_batch_mixed": screen_fused_batch.mixed}


def on_cuda() -> bool:
    """A Hopper-class card (compute capability 9.x) is present."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0)[0] == 9)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["screen_fused", "screen_scores", "ub_histogram", "cm_burst",
           "cm_burst_xt", "cm_burst_pen_xt", "cm_smem_ok",
           "CM_SMEM_BUDGET_BYTES", "chain_suffix_sums", "screen_fused_batch",
           "ub_histogram_batch", "cm_burst_batch_xt",
           "screen_fused_ref", "screen_scores_ref", "ub_histogram_ref",
           "cm_burst_ref", "chain_suffix_sums_ref", "screen_fused_batch_ref",
           "ub_histogram_batch_ref", "cm_burst_batch_ref", "cm_epochs",
           "cm_epochs_ref", "cm_epochs_smem_ok", "gram_sweep",
           "gram_sweep_batch", "gram_sweep_ref", "gram_sweep_batch_ref",
           "gram_smem_ok", "screen_tail", "screen_tail_batch",
           "screen_tail_ref", "screen_tail_batch_ref", "cm_sweep_wide",
           "cm_sweep_wide_ref", "cm_wide_smem_ok", "group_bcd",
           "group_bcd_ref", "group_smem_ok", "on_cuda",
           "launch_counts", "reset_launch_counts", "KERNELS"]
