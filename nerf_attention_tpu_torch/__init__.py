"""nerf_attention_tpu_torch: the SIREN KV-cache compression study in PyTorch and CUDA.

The port of ``nerf_attention_tpu`` (JAX on a TPU) to an NVIDIA H100. This
facade exports the port's counterpart of every name of the JAX package's,
but ``llama_prefill_kv_pp`` and ``shard_mla_params``, the pipeline-parallel
prefill and the MLA layout, which wait for later slices of the multi-device
port (``ROADMAP.md`` queue 1, item 8); the multi-device ones it has
(``fit_mesh``, the ``*_sharded`` kernels, ``llama_prefill_kv_sp``) run SPMD
on a ``torch.distributed`` mesh. ``models.llama.shard_llama_params`` (the
Llama's tensor parallelism) stays out of it, as it is out of JAX's.
``siren_decode_fused`` is kernel 2B's wrapper, ``siren_decode``. It imports
plain modules only: the CUDA kernels build at their first launch, never on
import.
"""

from nerf_attention_tpu_torch.types import (
    CONFIGS_BY_NAME,
    CONFIGS_FULL,
    CONFIGS_QUICK,
    AnalysisResult,
    FitResult,
    KVMetadata,
    LayerSummary,
    SIRENConfig,
)
from nerf_attention_tpu_torch.models.siren import (
    Siren,
    SirenStack,
    fm_frequency_multipliers,
    init_siren,
    positions,
    siren_apply,
    siren_apply_fm,
    siren_apply_maybe_fm,
)
from nerf_attention_tpu_torch.extract import (
    extract_kv_cache,
    extract_kv_cache_jax,
    extract_kv_cache_synthetic,
    get_sample_text,
)
from nerf_attention_tpu_torch.models.llama_hybrid import (
    llama_decode_step_quantcache,
    make_hybrid_decode_step,
    make_hybrid_rollout,
    pack_llama_kv_cache,
)
from nerf_attention_tpu_torch.models.llama import (
    llama_decode_rollout,
    llama_decode_step,
    llama_prefill_kv,
    llama_prefill_kv_sp,
)
from nerf_attention_tpu_torch.models.mla import (
    MLAConfig,
    load_mla_params,
    materialize_from_latent,
    mla_decode_rollout,
    mla_decode_step,
    mla_decode_step_absorbed,
    mla_decode_step_absorbed_quant,
    mla_decode_step_latent,
    mla_prefill_kv,
    pack_mla_latent_stack,
)
from nerf_attention_tpu_torch.synthetic import generate_synthetic_kv
from nerf_attention_tpu_torch.analyze import analyze_kv_cache
from nerf_attention_tpu_torch.fit import fit_kv_cache, fit_siren
from nerf_attention_tpu_torch.parallel.mesh import fit_mesh
from nerf_attention_tpu_torch.parallel.sweep import fit_batch
from nerf_attention_tpu_torch.models.siren_shared import (
    fit_shared_batch,
    init_shared,
    shared_apply,
    shared_bytes_per_unit,
)
from nerf_attention_tpu_torch.evaluate import (
    generate_summary_figure,
    load_results,
    plot_keys_vs_values,
    plot_pareto_frontier,
    plot_per_position_error,
    profile_latency,
)
from nerf_attention_tpu_torch.ops.fastmath import fast_cos, fast_sin, fast_sincos
from nerf_attention_tpu_torch.ops.qat import qat_finetune_batch
from nerf_attention_tpu_torch.io.quantized import save_quantized_siren_checkpoint
from nerf_attention_tpu_torch.ops.quantize import param_bytes, parse_scheme, quantize_params, split_scheme
from nerf_attention_tpu_torch.ops.siren_cuda import siren_decode, siren_decode_batch
from nerf_attention_tpu_torch.ops.siren_cuda import siren_decode as siren_decode_fused
from nerf_attention_tpu_torch.ops.siren_train_cuda import siren_train_grads
from nerf_attention_tpu_torch.ops.siren_attention_cuda import siren_attention_decode, siren_attention_decode_fused
from nerf_attention_tpu_torch.ops.siren_quant_cuda import (
    pack_resident_params,
    resident_param_bytes,
    siren_attention_decode_quant,
    siren_attention_decode_quant_sharded,
    siren_decode_batch_quant,
    siren_decode_batch_quant_sharded,
)
from nerf_attention_tpu_torch.ops.mla_absorbed_cuda import mla_absorbed_attention
from nerf_attention_tpu_torch.ops.kv_quant_cuda import kv_cache_attention_quant, pack_kv_unit_stack, resident_kv_bytes
from nerf_attention_tpu_torch.ops.mla_quant_cuda import (
    mla_absorbed_attention_quant,
    pack_resident_latent,
    resident_latent_bytes,
)
from nerf_attention_tpu_torch.measure_entropy import measure_model_entropy
from nerf_attention_tpu_torch.serve_plan import (
    apply_layer_windows,
    build_plan,
    build_tiered_plan,
    fit_reprice,
    latent_units_from_json,
    law_cost,
    recommend_probes,
    reprice_units,
    tiered_units_from_policy_json,
    units_from_fits,
    units_from_policy_json,
)

siren_forward = siren_apply  # the JAX package's jitted single-network forward

__all__ = [
    "CONFIGS_BY_NAME",
    "CONFIGS_FULL",
    "CONFIGS_QUICK",
    "AnalysisResult",
    "FitResult",
    "KVMetadata",
    "LayerSummary",
    "SIRENConfig",
    "Siren",
    "SirenStack",
    "init_siren",
    "positions",
    "siren_apply",
    "siren_forward",
    "extract_kv_cache",
    "extract_kv_cache_jax",
    "extract_kv_cache_synthetic",
    "generate_synthetic_kv",
    "get_sample_text",
    "analyze_kv_cache",
    "fit_kv_cache",
    "fit_siren",
    "fit_batch",
    "fit_mesh",
    "fit_shared_batch",
    "init_shared",
    "shared_apply",
    "shared_bytes_per_unit",
    "load_results",
    "plot_pareto_frontier",
    "plot_keys_vs_values",
    "plot_per_position_error",
    "profile_latency",
    "generate_summary_figure",
    "fast_sin",
    "fast_cos",
    "fast_sincos",
    "siren_decode",
    "siren_decode_fused",
    "siren_decode_batch",
    "siren_train_grads",
    "siren_attention_decode",
    "siren_attention_decode_fused",
    "siren_attention_decode_quant",
    "siren_decode_batch_quant",
    "siren_attention_decode_quant_sharded",
    "siren_decode_batch_quant_sharded",
    "pack_resident_params",
    "resident_param_bytes",
    "llama_decode_rollout",
    "llama_decode_step",
    "make_hybrid_decode_step",
    "make_hybrid_rollout",
    "llama_decode_step_quantcache",
    "pack_llama_kv_cache",
    "llama_prefill_kv",
    "llama_prefill_kv_sp",
    "MLAConfig",
    "load_mla_params",
    "materialize_from_latent",
    "mla_absorbed_attention",
    "mla_decode_rollout",
    "mla_decode_step",
    "mla_decode_step_absorbed",
    "mla_decode_step_absorbed_quant",
    "pack_mla_latent_stack",
    "mla_absorbed_attention_quant",
    "kv_cache_attention_quant",
    "pack_kv_unit_stack",
    "resident_kv_bytes",
    "pack_resident_latent",
    "resident_latent_bytes",
    "mla_decode_step_latent",
    "mla_prefill_kv",
    "fm_frequency_multipliers",
    "siren_apply_fm",
    "siren_apply_maybe_fm",
    "quantize_params",
    "save_quantized_siren_checkpoint",
    "param_bytes",
    "parse_scheme",
    "split_scheme",
    "qat_finetune_batch",
    "build_plan",
    "apply_layer_windows",
    "build_tiered_plan",
    "latent_units_from_json",
    "measure_model_entropy",
    "law_cost",
    "fit_reprice",
    "recommend_probes",
    "reprice_units",
    "tiered_units_from_policy_json",
    "units_from_fits",
    "units_from_policy_json",
]

__version__ = "0.1.0"
