"""The paper's split-inference core, ported: reinterpretation, sub-layer
splitting, activation mapping, allocation, quantization and the two
executors.  The numpy modules are copies of the reference's; quantize's
torch half and the executors run on CUDA or, when asked, the CPU.

The executors are imported on first access: the kernels they launch import
``core.quantize``, so an eager import here would be circular."""
import importlib
from .allocation import (WorkerParams, allocate, band_bounds, band_heights,
                         capability_rating, execution_time,
                         proportional_allocation, ratings_evenly, ratings_for,
                         ratings_freq_only, redistribute_overflow)
from .fusion import (BatchNormParams, FusedBlock, apply_activation,
                     fold_batchnorm, group_blocks)
from .mapping import (assignm_bruteforce, comm_volume, compile_shard_geometry,
                      routem_bruteforce, worker_input_regions)
from .quantize import (QuantizedLayer, QuantizedModel, calibrate_scales,
                       epilogue_params, quantize_model, requantize)
from .reinterpret import (LayerSpec, ReinterpretedModel, layer_macs,
                          trace_sequential)
from .splitting import (LayerSplit, ShardGeometry, SpatialBandGeometry,
                        SpatialShard, SplitPlan, WorkerShard, partition_bounds,
                        spatial_band_geometry, split_layer, split_model,
                        split_model_mixed)

__all__ = [
    "WorkerParams", "allocate", "band_bounds", "band_heights",
    "capability_rating", "execution_time", "proportional_allocation",
    "ratings_evenly", "ratings_for", "ratings_freq_only",
    "redistribute_overflow",
    "CompiledSplitExecutor", "SplitExecutor", "reference_forward",
    "resolve_device",
    "BatchNormParams", "FusedBlock", "apply_activation", "fold_batchnorm",
    "group_blocks",
    "assignm_bruteforce", "comm_volume", "compile_shard_geometry",
    "routem_bruteforce", "worker_input_regions",
    "QuantizedLayer", "QuantizedModel", "calibrate_scales", "epilogue_params",
    "quantize_model", "requantize",
    "LayerSpec", "ReinterpretedModel", "layer_macs", "trace_sequential",
    "LayerSplit", "ShardGeometry", "SpatialBandGeometry", "SpatialShard",
    "SplitPlan", "WorkerShard", "partition_bounds", "spatial_band_geometry",
    "split_layer", "split_model", "split_model_mixed",
]

_EXECUTOR_NAMES = ("CompiledSplitExecutor", "SplitExecutor",
                   "reference_forward", "resolve_device")


def __getattr__(name):
    if name in _EXECUTOR_NAMES:
        return getattr(importlib.import_module(".executor", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
