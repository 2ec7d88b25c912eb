"""The Llama family decoder: prefill with post-RoPE K/V capture, the decode step, the rollout and the HF loader.

The port of ``nerf_attention_tpu/models/llama_jax.py`` for every family its
``LlamaConfig`` implements (``_SUPPORTED_MODEL_TYPES``: llama, mistral,
mixtral, qwen2, qwen2_moe, qwen3, qwen3_moe, gemma, gemma2, gemma3_text, phi3,
gpt_oss, olmo2, granite, cohere, cohere2, glm, glm4): sliding windows, uniform
or per layer; QK norms per head, flat (OLMo-2) and Cohere's per-head
LayerNorm; OLMo-2's norms after each sublayer, Cohere's parallel residual,
the Gemma-2/3 and GLM-4 sandwich norms, Granite's multipliers; interleaved and
partial rotary, Gemma-3's local rope base and Cohere-2's NoPE layers; llama3,
linear and YaRN rope scaling; soft-capped logits; GPT-OSS's attention sinks;
the Mixtral / Qwen / GPT-OSS sparse-MoE blocks. Numerics follow the JAX
module: fp32 logits, masked logits at fp32's most negative value, the new
token's own key as its own attention column, per-head attention entropy in
nats over the full softmax (the sink included).

What differs from the JAX module, and only in form:

* Parameters are ``{"embed": (V, hidden), "layers": [dict per layer]}``
  with the JAX leaf names; layers run as a Python loop in place of
  ``lax.scan``, and the per-layer flags of ``_scanned_layers`` (window, local
  rope, NoPE) are plain Python values of that loop (``_layer_kinds``).
  ``interop.llama_params_from_jax`` converts the JAX pytree (leaves stacked
  over layers).
* The decode step takes a leading batch of (token, position, cache) where
  the JAX package uses ``vmap``: token ids and positions of shape ``B``,
  caches ``(*C, L, n_kv, S, D)`` with ``C`` broadcastable to ``B``.
* ``llama_decode_rollout`` writes each step's K/V into the caller's
  pre-allocated buffers in place.
* ``load_llama_params`` reads safetensors with the port's own reader
  (``io/safetensors.py``), puts the weights on the device, checks every
  leaf's shape, and refuses a config with ``mlp_bias: true`` (the JAX
  loader ignores the MLP biases such a checkpoint carries).
* ``llama_prefill_kv_sp`` (the sequence-parallel prefill) runs SPMD on a
  ``torch.distributed`` mesh (``parallel/mesh.py``): every rank passes the
  whole token sequence and returns the whole cache, where JAX's returns it
  row-sharded.
* Tensor parallelism (``shard_llama_params``, JAX's Megatron layout) runs
  SPMD on such a mesh too: each rank holds its heads' and its FFN columns'
  weights, and the prefill, the decode step and the rollout take the sharded
  params in place of ``params``. Where JAX's GSPMD inserts the collectives,
  the forward calls them itself: one sum over the ranks a sublayer
  (``all_reduce_sum``), K/V and per-head outputs gathered over heads. The
  shard takes the config (it cuts at head boundaries) and refuses what the
  port has no counterpart for: expert parallelism, and KV heads that neither
  divide over the ranks nor divide them. The pipeline-parallel prefill and
  expert parallelism are not ported (``ROADMAP.md`` queue 1, item 8).
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from nerf_attention_tpu_torch.io import kvstore
from nerf_attention_tpu_torch.io.safetensors import open_hf_weights
from nerf_attention_tpu_torch.io.tokenizer import load_tokenizer
from nerf_attention_tpu_torch.models.layers import (
    _apply_rope,
    _causal_attention,
    _ffn,
    _layer_norm,
    _mlp_act,
    _rms_norm,
    _softcap,
)
from nerf_attention_tpu_torch.parallel.mesh import (
    LocalShard,
    all_reduce_sum,
    barrier,
    check_divisible,
    check_on_mesh,
    gather_rows,
    local_rows,
    mesh_device,
    pad_to_multiple,
)
from nerf_attention_tpu_torch.types import KVMetadata
from nerf_attention_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class LlamaConfig:
    """``llama_jax.LlamaConfig``: every field, under the same names and defaults (see the JAX class for each)."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    rope_theta: float = 10000.0  # HF LlamaConfig default (Llama-2 era)
    rms_norm_eps: float = 1e-6  # HF LlamaConfig default
    sliding_window: int | None = None  # uniform window (Mistral)
    hidden_act: str = "silu"
    norm_offset: bool = False  # Gemma: RMSNorm scales by (1 + w)
    scale_embeddings: bool = False  # Gemma: embeddings times sqrt(hidden)
    embedding_multiplier: float | None = None  # Granite
    residual_multiplier: float = 1.0  # Granite
    qk_norm: bool = False  # per-head Q/K norm before RoPE (Qwen3, Gemma3, Cohere)
    qk_norm_full: bool = False  # OLMo-2: norm of the flat q/k projections
    norm_after_only: bool = False  # OLMo-2: no pre-norms, a norm on each sublayer's output
    layernorm: bool = False  # Cohere: mean-centred LayerNorm everywhere
    parallel_residual: bool = False  # Cohere: h + attn(norm(h)) + mlp(norm(h))
    rope_interleaved: bool = False  # Cohere / GLM: lanes paired (2i, 2i + 1)
    rope_skip_full_layers: bool = False  # Cohere2: full-attention layers take no rope
    rotary_dim: int | None = None  # partial rotary (GLM, Phi-3 small); None = head_dim
    attn_scale: float | None = None  # None -> rsqrt(head_dim)
    attn_logit_softcap: float | None = None  # logits -> cap * tanh(logits / cap)
    sandwich_norms: bool = False  # Gemma2 / GLM-4 post-attn and pre / post-FFN norms
    layer_windows: tuple | None = None  # per-layer windows (None entry = full attention)
    rope_local_theta: float | None = None  # Gemma3 sliding layers' rope base
    rope_linear_factor: float | None = None  # 'linear' rope scaling
    num_local_experts: int | None = None  # sparse-MoE FFN (None = dense)
    num_experts_per_tok: int = 2
    moe_style: str = "mixtral"  # mixtral | qwen3_moe | qwen2_moe | gpt_oss
    moe_renormalize: bool = True
    shared_expert_intermediate_size: int | None = None  # Qwen2-MoE shared expert
    attn_sinks: bool = False  # GPT-OSS per-head sink logit
    rope_scaling_factor: float | None = None  # llama3 rope scaling
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    yarn_factor: float | None = None  # YaRN rope scaling
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_original_max_position: int = 4096
    yarn_truncate: bool = True
    yarn_attention_factor: float | None = None

    def __post_init__(self):
        if self.qk_norm and self.qk_norm_full:
            raise ValueError("qk_norm (per-head) and qk_norm_full (flat projection) are mutually exclusive")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(f"{self.num_attention_heads} query heads do not group over "
                             f"{self.num_key_value_heads} KV heads")

    @property
    def attention_scaling(self) -> float:
        """YaRN's post-factor on cos/sin (1.0 for every non-yarn family)."""
        if self.yarn_factor is None:
            return 1.0
        if self.yarn_attention_factor is not None:
            return self.yarn_attention_factor
        if self.yarn_factor <= 1:
            return 1.0
        return 0.1 * math.log(self.yarn_factor) + 1.0

    @staticmethod
    def _resolve_sliding_window(d: dict) -> int | None:
        """Uniform window across families: Qwen2/3's is inert unless ``use_sliding_window``; Mistral's absent key
        means HF's MistralConfig default 4096."""
        if "use_sliding_window" in d or d.get("model_type") in ("qwen2", "qwen3"):
            if not d.get("use_sliding_window", False):
                return None
            return d.get("sliding_window", 4096)
        if d.get("model_type") == "mistral":
            return d.get("sliding_window", 4096)
        return d.get("sliding_window")

    @classmethod
    def _resolve_windows(cls, d: dict) -> tuple["int | None", "tuple | None"]:
        """(uniform sliding_window, per-layer windows) of an HF config dict: ``layer_types`` where given (else the
        family's own rule for gemma2 / gemma3_text / gpt_oss / cohere2), Qwen's ``max_window_layers``, or the
        uniform window; a uniform per-layer result collapses to ``sliding_window``."""
        n_layers = d["num_hidden_layers"]
        layer_types = d.get("layer_types")
        if layer_types is None and d.get("model_type") in ("gemma2", "gemma3_text", "gpt_oss", "cohere2"):
            period = (d.get("sliding_window_pattern", 6) if d["model_type"] == "gemma3_text"
                      else d.get("sliding_window_pattern", 4) if d["model_type"] == "cohere2" else 2)
            layer_types = ["sliding_attention" if (i + 1) % period else "full_attention" for i in range(n_layers)]
        if layer_types:
            sw = d.get("sliding_window", 4096) if d.get("model_type") == "cohere2" else d.get("sliding_window")
            windows = tuple(sw if t == "sliding_attention" else None for t in layer_types)
        elif d.get("use_sliding_window", False):
            sw = d.get("sliding_window", 4096)
            first_full = d.get("max_window_layers", 28)
            windows = tuple(None if i < first_full else sw for i in range(n_layers))
        else:
            return cls._resolve_sliding_window(d), None
        if all(w is None for w in windows):
            return None, None
        if all(w == windows[0] for w in windows):
            return windows[0], None
        return None, windows

    @classmethod
    def from_hf_dict(cls, d: dict) -> "LlamaConfig":
        """The config of an HF ``config.json`` dict, field for field as the JAX method reads it.

        Refuses what the JAX method refuses (other model types, mixed dense /
        MoE Qwen stacks, Gemma-3's bidirectional attention, rope scaling other
        than llama3 / linear / yarn), and ``mlp_bias: true``, whose MLP biases
        the forward does not apply.
        """
        model_type = d.get("model_type")
        if model_type not in _SUPPORTED_MODEL_TYPES:
            raise NotImplementedError(
                f"model_type {model_type!r} is not supported (have: llama, mistral, mixtral, qwen2, qwen2_moe, "
                "qwen3, qwen3_moe, gemma, gemma2, gemma3_text, phi3, gpt_oss, olmo2, granite, cohere, cohere2, glm, "
                "glm4)")
        if model_type in ("qwen3_moe", "qwen2_moe") and (d.get("mlp_only_layers")
                                                          or d.get("decoder_sparse_step", 1) != 1):
            raise NotImplementedError(f"{model_type} with mlp_only_layers or decoder_sparse_step != 1 (mixed "
                                      "dense/MoE layers) is not supported")
        if model_type == "gemma3_text" and d.get("use_bidirectional_attention"):
            raise NotImplementedError("gemma3 bidirectional attention (embedding variants) is not supported")
        if d.get("mlp_bias", False):
            raise NotImplementedError("mlp_bias=True is not supported: the forward applies no MLP biases")
        scaling = d.get("rope_scaling") or {}
        rope_type = scaling.get("rope_type", scaling.get("type"))
        if scaling and rope_type not in ("llama3", "linear", "yarn", "default", None):
            raise NotImplementedError(f"rope_scaling type {rope_type!r} is not supported "
                                      "(plain RoPE, llama3 rescaling, linear, and yarn are)")
        num_heads = d["num_attention_heads"]
        sliding_window, layer_windows = cls._resolve_windows(d)
        gemma_like = model_type in ("gemma", "gemma2", "gemma3_text")
        cohere_like = model_type in ("cohere", "cohere2")
        glm_like = model_type in ("glm", "glm4")
        head_dim = d.get("head_dim") or d["hidden_size"] // num_heads
        partial = d.get("partial_rotary_factor", 0.5 if glm_like else 1.0)
        if model_type in ("gemma2", "gemma3_text"):
            hidden_act = d.get("hidden_activation", "gelu_pytorch_tanh")
            attn_scale = d.get("query_pre_attn_scalar", 256) ** -0.5
        else:
            hidden_act = d.get("hidden_act", "silu")  # GemmaMLP reads hidden_act, not hidden_activation
            attn_scale = d.get("attention_multiplier", 1.0) if model_type == "granite" else None
        moe_types = ("qwen3_moe", "qwen2_moe")
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=(d.get("moe_intermediate_size", 768 if model_type == "qwen3_moe" else 1408)
                               if model_type in moe_types else d["intermediate_size"]),
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=num_heads,
            num_key_value_heads=d.get("num_key_value_heads", num_heads),
            head_dim=head_dim,
            rotary_dim=int(head_dim * partial) if partial != 1.0 else None,
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("layer_norm_eps", 1e-5) if cohere_like else d.get("rms_norm_eps", 1e-6),
            sliding_window=sliding_window,
            layer_windows=layer_windows,
            hidden_act=hidden_act,
            norm_offset=gemma_like,
            scale_embeddings=gemma_like,
            qk_norm=(model_type in ("qwen3", "qwen3_moe", "gemma3_text")
                     or (model_type == "cohere" and d.get("use_qk_norm", False))),
            qk_norm_full=model_type == "olmo2",
            norm_after_only=model_type == "olmo2",
            layernorm=cohere_like,
            parallel_residual=cohere_like,
            rope_interleaved=cohere_like or glm_like,
            rope_skip_full_layers=model_type == "cohere2",
            embedding_multiplier=d.get("embedding_multiplier", 1.0) if model_type == "granite" else None,
            residual_multiplier=d.get("residual_multiplier", 1.0) if model_type == "granite" else 1.0,
            attn_scale=attn_scale,
            attn_logit_softcap=d.get("attn_logit_softcapping", 50.0) if model_type == "gemma2" else None,
            sandwich_norms=model_type in ("gemma2", "gemma3_text", "glm4"),
            rope_local_theta=d.get("rope_local_base_freq", 10000.0) if model_type == "gemma3_text" else None,
            rope_linear_factor=scaling.get("factor") if rope_type == "linear" else None,
            rope_scaling_factor=scaling.get("factor") if rope_type == "llama3" else None,
            rope_low_freq_factor=scaling.get("low_freq_factor", 1.0),
            rope_high_freq_factor=scaling.get("high_freq_factor", 4.0),
            rope_original_max_position=scaling.get("original_max_position_embeddings", 8192),
            num_local_experts=(d.get("num_local_experts", 8) if model_type == "mixtral"
                               else d.get("num_local_experts", 128) if model_type == "gpt_oss"
                               else d.get("num_experts", 128 if model_type == "qwen3_moe" else 60)
                               if model_type in moe_types else None),
            num_experts_per_tok=d.get("num_experts_per_tok",
                                      {"gpt_oss": 4, "qwen3_moe": 8, "qwen2_moe": 4}.get(model_type, 2)),
            moe_style=model_type if model_type in ("gpt_oss", *moe_types) else "mixtral",
            moe_renormalize=d.get("norm_topk_prob", False) if model_type in moe_types else True,
            shared_expert_intermediate_size=(d.get("shared_expert_intermediate_size", 5632)
                                             if model_type == "qwen2_moe" else None),
            attn_sinks=model_type == "gpt_oss",
            yarn_factor=scaling.get("factor") if rope_type == "yarn" else None,
            yarn_beta_fast=scaling.get("beta_fast") or 32.0,
            yarn_beta_slow=scaling.get("beta_slow") or 1.0,
            yarn_original_max_position=(scaling.get("original_max_position_embeddings")
                                        or d.get("max_position_embeddings", 4096)),
            yarn_truncate=scaling.get("truncate", True),
            yarn_attention_factor=scaling.get("attention_factor"),
        )


_SUPPORTED_MODEL_TYPES = frozenset({
    None, "llama", "mistral", "qwen2", "qwen2_moe", "qwen3", "qwen3_moe", "gemma", "gemma2", "gemma3_text", "phi3",
    "mixtral", "gpt_oss", "olmo2", "granite", "cohere", "cohere2", "glm", "glm4",
})


def _rope_frequencies(config: LlamaConfig, theta: float | None = None) -> np.ndarray:
    """Inverse frequencies (rotary_dim / 2,) fp32: llama3, linear or YaRN rescaling where set.

    ``theta`` overrides the base (Gemma3's local table, built unscaled).
    Computed in numpy float64 and rounded once, as the JAX module does.
    """
    d = config.rotary_dim or config.head_dim
    base = config.rope_theta if theta is None else theta
    inv_freq = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float64) / d))
    if theta is None and config.rope_linear_factor is not None:
        inv_freq = inv_freq / config.rope_linear_factor
    if theta is None and config.yarn_factor is not None:
        # HF _compute_yarn_parameters: interpolated below beta_slow's bound, extrapolated above beta_fast's.
        factor, orig = config.yarn_factor, config.yarn_original_max_position

        def correction_dim(num_rotations: float) -> float:
            return d * math.log(orig / (num_rotations * 2 * math.pi)) / (2 * math.log(base))

        low, high = correction_dim(config.yarn_beta_fast), correction_dim(config.yarn_beta_slow)
        if config.yarn_truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, d - 1)
        if low == high:
            high += 0.001  # HF's singularity guard
        extrapolation = 1.0 - np.clip((np.arange(d // 2, dtype=np.float64) - low) / (high - low), 0, 1)
        return ((inv_freq / factor) * (1 - extrapolation) + inv_freq * extrapolation).astype(np.float32)
    if config.rope_scaling_factor is None:
        return inv_freq.astype(np.float32)
    # "llama3": low-frequency bands divided by `factor`, high ones kept, a smooth ramp between.
    factor = config.rope_scaling_factor
    low, high = config.rope_low_freq_factor, config.rope_high_freq_factor
    orig = config.rope_original_max_position
    wavelen = 2 * np.pi / inv_freq
    low_wavelen, high_wavelen = orig / low, orig / high
    scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (orig / wavelen - low) / (high - low)
    interp = (1 - smooth) / factor * inv_freq + smooth * inv_freq
    is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(is_medium, interp, scaled).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _inv_freq(config: LlamaConfig, device: torch.device, theta: float | None = None) -> torch.Tensor:
    """``_rope_frequencies`` on the device, copied there once: a decode step
    makes no host-to-device copy (which would wait for the device)."""
    return torch.from_numpy(_rope_frequencies(config, theta)).to(device)


def _rope_tables(config: LlamaConfig, positions: torch.Tensor, dtype, theta: float | None = None):
    """(*positions.shape, rotary_dim) cos and sin, angles duplicated in the family's pairing (cat(freqs, freqs),
    or each repeated twice where interleaved), times YaRN's attention factor on the global table."""
    angles = positions.to(torch.float32)[..., None] * _inv_freq(config, positions.device, theta)
    if config.rope_interleaved:
        angles = torch.repeat_interleave(angles, 2, dim=-1)
    else:
        angles = torch.cat([angles, angles], dim=-1)
    scale = float(np.float32(config.attention_scaling if theta is None else 1.0))
    return (torch.cos(angles) * scale).to(dtype), (torch.sin(angles) * scale).to(dtype)


def _layer_kinds(config: LlamaConfig) -> list[tuple]:
    """Per layer (window or None, rope table: "global", "local" or None): the flags ``_scanned_layers`` scans.

    A per-layer window of 0 or None is full attention. Gemma3's windowed
    layers rotate with the local-base table; Cohere2's full layers take no
    rope (the JAX module's identity tables).
    """
    kinds = []
    for i in range(config.num_hidden_layers):
        if config.layer_windows is not None:
            window = config.layer_windows[i] or None
        else:
            window = config.sliding_window
        rope = "global"
        if config.rope_local_theta is not None and window is not None:
            rope = "local"
        if config.rope_skip_full_layers and window is None:
            rope = None
        kinds.append((window, rope))
    return kinds


def _tables(config: LlamaConfig, positions: torch.Tensor, dtype) -> dict:
    """The rope tables the layers read, by ``_layer_kinds``'s name."""
    tables = {"global": _rope_tables(config, positions, dtype)}
    if config.rope_local_theta is not None:
        tables["local"] = _rope_tables(config, positions, dtype, config.rope_local_theta)
    return tables


def _norm(config: LlamaConfig, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The family's norm: Cohere's LayerNorm, else RMSNorm (Gemma's (1 + w) where set)."""
    if config.layernorm:
        return _layer_norm(x, weight, config.rms_norm_eps)
    return _rms_norm(x, weight, config.rms_norm_eps, config.norm_offset)


def _embed(config: LlamaConfig, embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows, times sqrt(hidden) (Gemma) and Granite's multiplier, each cast to the dtype first."""
    h = embed[ids]
    if config.scale_embeddings:
        h = h * torch.tensor(config.hidden_size ** 0.5, dtype=h.dtype, device=h.device)
    if config.embedding_multiplier is not None:
        h = h * torch.tensor(config.embedding_multiplier, dtype=h.dtype, device=h.device)
    return h


def _qk_norm_weights(lp: dict, q_shape: tuple, k_shape: tuple):
    """The per-head QK-norm weights shaped for q and k; Cohere's are per head, (heads, head_dim)."""
    qw, kw = lp["q_norm"], lp["k_norm"]
    if qw.dim() == 2:
        qw, kw = qw.reshape(q_shape), kw.reshape(k_shape)
    return qw, kw


def _layer_tail(config: LlamaConfig, h, x, attn_flat, lp, tp: "TPLayout | None" = None):
    """The attention-output projection and the family's residual wiring around the FFN.

    ``x`` is the layer's input-norm output (Cohere's FFN reads it). Returns
    (h, ffn_x): ffn_x is the tensor the FFN read (a sparse-MoE router's input).
    Under tensor parallelism (``tp``) ``attn_flat`` holds the rank's heads and
    the FFN its columns, so each sublayer's output is a partial sum, summed
    over the ranks before the residual or a norm reads it, and ``o_bias``
    (replicated) is added once after that sum. Cohere's parallel block takes
    one sum of both partials. GPT-OSS's experts are replicated under TP:
    their output is whole on every rank and is not summed.
    """
    act = _mlp_act(config.hidden_act)
    attn_sum = (lambda y: y) if tp is None else tp.reduce
    ffn_sum = attn_sum if config.moe_style != "gpt_oss" or not config.num_local_experts else (lambda y: y)
    if config.parallel_residual:
        ffn_out = _ffn(config, x, lp, act)
        if tp is None:
            return h + (attn_flat @ lp["o"] + lp["o_bias"]) + ffn_out, x
        if ffn_sum is attn_sum:
            return h + (tp.reduce(attn_flat @ lp["o"] + ffn_out) + lp["o_bias"]), x
        return h + (tp.reduce(attn_flat @ lp["o"]) + lp["o_bias"]) + ffn_out, x
    attn_out = attn_sum(attn_flat @ lp["o"]) + lp["o_bias"]
    if config.sandwich_norms or config.norm_after_only:
        h = h + _norm(config, attn_out, lp["post_norm"])
        x = h if config.norm_after_only else _norm(config, h, lp["pre_ffn_norm"])
        return h + _norm(config, ffn_sum(_ffn(config, x, lp, act)), lp["post_ffn_norm"]), x
    rm = config.residual_multiplier
    h = h + (attn_out if rm == 1.0 else attn_out * rm)
    x = _norm(config, h, lp["post_norm"])
    ffn_out = ffn_sum(_ffn(config, x, lp, act))
    return h + (ffn_out if rm == 1.0 else ffn_out * rm), x


def _heads(config: LlamaConfig, tp: "TPLayout | None") -> tuple[int, int]:
    """(query heads, KV heads) this rank computes: all of them, or its TP shard's."""
    if tp is None:
        return config.num_attention_heads, config.num_key_value_heads
    return tp.n_q, tp.n_kv


def _flat_qk_norm(config: LlamaConfig, q_flat, k_flat, lp, tp: "TPLayout | None"):
    """OLMo-2's RMSNorm of the flat q and k projections (each over all n_heads * D columns).

    Under TP a rank holds its heads' columns and its slice of the weights:
    the sum of squares is summed over the ranks in fp32, then each rank
    scales its columns. Where the KV heads are replicated, only each head's
    first holder adds its k columns' squares, so every column counts once.
    """
    if tp is None:
        return _norm(config, q_flat, lp["q_norm"]), _norm(config, k_flat, lp["k_norm"])
    d = config.head_dim

    def norm(x, weight, width, counted):
        xf = x.float()
        squares = torch.sum(xf * xf, dim=-1, keepdim=True)
        total = tp.reduce(squares if counted else torch.zeros_like(squares))
        w = weight.float()
        return (xf * torch.rsqrt(total / width + config.rms_norm_eps) * (1.0 + w if config.norm_offset else w)
                ).to(x.dtype)

    return (norm(q_flat, lp["q_norm"], config.num_attention_heads * d, True),
            norm(k_flat, lp["k_norm"], config.num_key_value_heads * d, tp.kv_first))


def _layer_forward(config: LlamaConfig, h, lp, kind, tables, kv_join=None, row_offset: int = 0,
                   tp: "TPLayout | None" = None):
    """One decoder layer over the sequence h (S, hidden). Returns (h, (keys, values)), each (n_kv, S, D).

    ``kv_join(k, v)``: where h holds a sequence-parallel slice of the rows
    starting at global row ``row_offset`` (``tables`` at those positions), the
    whole sequence's (n_kv, S_total, D) keys and values from this slice's;
    attention then sees the whole prefix, masked in global coordinates, and
    the joined keys and values are returned. ``tp``: this rank's heads of a
    tensor-parallel layer (``lp`` its shard); the keys and values are its KV
    heads', and h comes back whole.
    """
    (n_q, n_kv), d = _heads(config, tp), config.head_dim
    s = h.shape[0]
    window, rope = kind
    x = h if config.norm_after_only else _norm(config, h, lp["input_norm"])
    q_flat, k_flat = x @ lp["q"] + lp["q_bias"], x @ lp["k"] + lp["k_bias"]
    if config.qk_norm_full:
        q_flat, k_flat = _flat_qk_norm(config, q_flat, k_flat, lp, tp)
    q = q_flat.reshape(s, n_q, d).transpose(0, 1)
    k = k_flat.reshape(s, n_kv, d).transpose(0, 1)
    v = (x @ lp["v"] + lp["v_bias"]).reshape(s, n_kv, d).transpose(0, 1)
    if config.qk_norm:
        qw, kw = _qk_norm_weights(lp, (n_q, 1, d), (n_kv, 1, d))
        q, k = _norm(config, q, qw), _norm(config, k, kw)
    if rope is not None:  # the cache holds post-RoPE keys, like HF
        cos, sin = tables[rope]
        q, k = _apply_rope(q, cos, sin, config.rope_interleaved), _apply_rope(k, cos, sin, config.rope_interleaved)
    if kv_join is not None:
        k, v = kv_join(k, v)
    group = n_q // n_kv
    attn = _causal_attention(q, k.repeat_interleave(group, dim=0), v.repeat_interleave(group, dim=0),
                             scale=config.attn_scale, window=window, softcap=config.attn_logit_softcap,
                             sinks=lp["sinks"] if config.attn_sinks else None, row_offset=row_offset)
    h, _ = _layer_tail(config, h, x, attn.transpose(0, 1).reshape(s, n_q * d), lp, tp)
    return h, (k, v)


@torch.no_grad()
def llama_prefill_kv(config: LlamaConfig, params: dict, input_ids):
    """One prefill pass -> per-layer post-RoPE KV, each (num_layers, num_kv_heads, S, head_dim).

    ``params`` may be ``shard_llama_params``'s: every rank of its mesh calls
    this with the same ids, runs its heads, and gets the whole K/V, gathered
    over heads once at the end.
    """
    tp = _layout(params)
    ids = torch.as_tensor(np.asarray(input_ids), device=params["embed"].device).long()
    h = _embed(config, params["embed"], ids)
    tables = _tables(config, torch.arange(ids.shape[0], device=h.device), h.dtype)
    keys, values = [], []
    for lp, kind in zip(params["layers"], _layer_kinds(config)):
        h, (k, v) = _layer_forward(config, h, lp, kind, tables, tp=tp)
        keys.append(k), values.append(v)
    keys, values = torch.stack(keys), torch.stack(values)
    if tp is None:
        return keys, values
    return tp.gather_kv(keys, 1), tp.gather_kv(values, 1)


@torch.no_grad()
def llama_prefill_kv_sp(config: LlamaConfig, params: dict, input_ids, mesh):
    """Sequence-parallel prefill (``llama_jax.py:968``): the token axis sharded over a mesh.

    Every rank passes the whole ``input_ids`` (S divisible by the mesh size)
    and its replicated ``params``, on the mesh's kind of device. Rank r embeds its S/world tokens from
    global row r * S/world and runs every layer on them alone (activations,
    logits and FFN shrink by the world size), with rope tables at those
    global positions; per layer it all-gathers the (n_kv, S/world, D) K/V,
    the smallest tensor of the block under GQA, so attention sees the whole
    prefix, masked in global coordinates (causal, sliding windows, the
    gemma2/gemma3 per-layer windows and local rope, soft-cap, sinks). Returns
    the whole (L, n_kv, S, D) keys and values on every rank: the gathered K/V
    of each layer, with no further collective.
    """
    if "tp" in params:
        raise ValueError("the sequence-parallel prefill takes replicated params, not shard_llama_params' (SP and "
                         "TP are mutually exclusive, as in JAX)")
    check_on_mesh(params["embed"], mesh)
    ids = torch.as_tensor(np.asarray(input_ids)).long()
    check_divisible(int(ids.shape[0]), mesh, "seq_len")
    rows = local_rows(int(ids.shape[0]), mesh)
    device = mesh_device(mesh)
    ids = ids[rows].to(device)
    h = _embed(config, params["embed"], ids)
    tables = _tables(config, torch.arange(rows.start, rows.stop, device=device), h.dtype)

    def kv_join(k, v):
        return gather_rows(k, mesh, dim=1), gather_rows(v, mesh, dim=1)

    keys, values = [], []
    for lp, kind in zip(params["layers"], _layer_kinds(config)):
        h, (k, v) = _layer_forward(config, h, lp, kind, tables, kv_join=kv_join, row_offset=rows.start)
        keys.append(k), values.append(v)
    return torch.stack(keys), torch.stack(values)


def _qkv_from_x(config: LlamaConfig, x, lp, cos, sin, tp: "TPLayout | None" = None):
    """A layer's queries (*lead, n_kv, group, D), key and value (*lead, n_kv, 1, D) for tokens whose input-norm
    output is x (*lead, hidden), rotated by cos / sin (*lead, 1, 1, rotary_dim) unless those are None; the rank's
    heads under TP (``tp``)."""
    (n_q, n_kv), d = _heads(config, tp), config.head_dim
    lead, group = x.shape[:-1], n_q // n_kv
    q_flat, k_flat = x @ lp["q"] + lp["q_bias"], x @ lp["k"] + lp["k_bias"]
    if config.qk_norm_full:
        q_flat, k_flat = _flat_qk_norm(config, q_flat, k_flat, lp, tp)
    # Query head i * group + j reads KV head i (jnp.repeat order), so queries group as (n_kv, group).
    q = q_flat.reshape(*lead, n_kv, group, d)
    k = k_flat.reshape(*lead, n_kv, 1, d)
    v = (x @ lp["v"] + lp["v_bias"]).reshape(*lead, n_kv, 1, d)
    if config.qk_norm:
        qw, kw = _qk_norm_weights(lp, (n_kv, group, d), (n_kv, 1, d))
        q, k = _norm(config, q, qw), _norm(config, k, kw)
    if cos is None:
        return q, k, v
    return _apply_rope(q, cos, sin, config.rope_interleaved), _apply_rope(k, cos, sin, config.rope_interleaved), v


def _project_qkv(config: LlamaConfig, h, lp, cos, sin):
    """``_qkv_from_x`` on the input norm of the tokens h (*lead, hidden)."""
    return _qkv_from_x(config, _norm(config, h, lp["input_norm"]), lp, cos, sin)


def _attend_cache_and_self(q, k, v, cache_k, cache_v, visible, scale, softcap=None, sinks=None):
    """Softmax attention of q (..., group, D) over [the cache rows where ``visible``, its own k / v (..., 1, D)].

    Logits are soft-capped where ``softcap`` is set, the own column too;
    masked logits sit at fp32's most negative value; the own column always
    attends, so no row of the softmax is empty. ``sinks`` (..., group, 1):
    one more column after the own one, whose weight multiplies nothing.
    Returns (attn (..., group, D), probs (..., group, S + 1 [+ 1]) before the
    cast to the cache's dtype).
    """
    n = cache_k.shape[-2]
    cache_logits = _softcap((q.float() @ cache_k.float().transpose(-2, -1)) * scale, softcap)
    self_logit = _softcap((q.float() * k.float()).sum(-1, keepdim=True) * scale, softcap)  # the own column
    cache_logits = torch.where(visible, cache_logits, torch.finfo(torch.float32).min)
    cols = [cache_logits, self_logit]
    if sinks is not None:
        cols.append(sinks.float().expand_as(self_logit))
    probs = torch.softmax(torch.cat(cols, dim=-1), dim=-1)
    p = probs.to(cache_v.dtype)
    return p[..., :n] @ cache_v + p[..., n:n + 1] * v, probs


def _layer_decode(config: LlamaConfig, h, lp, kind, cache_k, cache_v, position, tables,
                  tp: "TPLayout | None" = None):
    """One layer for a batch of single tokens, each over its cache.

    h (*B, hidden); cache_k / cache_v (*C, n_kv, S, D) post-RoPE with C
    broadcastable to B; position an int or (*B,) tensor; tables the rope
    tables (*B, 1, 1, rotary_dim) by name. Cache rows before ``position``
    (and, in a windowed layer, within its window) attend, and the token's own
    row always; row ``position`` itself and everything past it are masked, so
    a pre-allocated buffer longer than the prefix decodes correctly. Returns
    (h, (k_new, v_new) (*B, n_kv, 1, D), entropy (*B, n_q), sink mass (*B,
    n_q), ffn_x (*B, hidden)). Under TP (``tp``) the caches, the new rows and
    the per-head outputs are the rank's heads'; h comes back whole.
    """
    (n_q, n_kv), d = _heads(config, tp), config.head_dim
    lead = h.shape[:-1]
    window, rope = kind
    x = h if config.norm_after_only else _norm(config, h, lp["input_norm"])
    cos, sin = tables[rope] if rope is not None else (None, None)
    q, k, v = _qkv_from_x(config, x, lp, cos, sin, tp)
    cols = torch.arange(cache_k.shape[-2], device=h.device)
    pos = position if isinstance(position, int) else position[..., None, None, None]
    visible = cols < pos
    if window is not None:
        visible = visible & (cols > pos - window)
    sinks = lp["sinks"].reshape(n_kv, n_q // n_kv, 1) if config.attn_sinks else None
    scale = d ** -0.5 if config.attn_scale is None else config.attn_scale
    attn, probs = _attend_cache_and_self(q, k, v, cache_k, cache_v, visible, scale,
                                         softcap=config.attn_logit_softcap, sinks=sinks)
    entropy = -torch.sum(torch.where(probs > 0, probs * torch.log(probs), 0.0), dim=-1).reshape(*lead, n_q)
    sink_mass = probs[..., -1].reshape(*lead, n_q) if config.attn_sinks else torch.zeros_like(entropy)
    h, ffn_x = _layer_tail(config, h, x, attn.reshape(*lead, -1), lp, tp)
    return h, (k, v, entropy, sink_mass, ffn_x)


def _decode(config: LlamaConfig, params: dict, token_id, position, cache_keys, cache_values, tp):
    """The decode step over caches of the rank's KV heads: (h, k_new, v_new, entropy, sink mass, ffn_x), the
    per-head ones over the rank's heads (``llama_decode_step``'s shapes otherwise)."""
    embed = params["embed"]
    if isinstance(token_id, torch.Tensor) and token_id.dim() > 0:
        token_id = token_id.to(embed.device)
        if not isinstance(position, torch.Tensor):  # a fill on the device, not a copy from the host
            position = torch.full((), int(position), device=embed.device)
        position = position.to(embed.device).expand(token_id.shape)
        h = _embed(config, embed, token_id.long())
        tables = _tables(config, position, h.dtype)
    else:
        h = _embed(config, embed, int(token_id))
        position = int(position)
        tables = _tables(config, torch.full((), position, device=embed.device), h.dtype)
    tables = {name: (cos[..., None, None, :], sin[..., None, None, :]) for name, (cos, sin) in tables.items()}
    outs = []
    for i, (lp, kind) in enumerate(zip(params["layers"], _layer_kinds(config))):
        h, out = _layer_decode(config, h, lp, kind, cache_keys[..., i, :, :, :], cache_values[..., i, :, :, :],
                               position, tables, tp)
        outs.append(out)
    axis = h.dim() - 1
    return (h, *(torch.stack(list(x), dim=axis) for x in zip(*outs)))


@torch.no_grad()
def llama_decode_step(config: LlamaConfig, params: dict, token_id, position, cache_keys, cache_values,
                      capture_ffn_input: bool = False, capture_sink_mass: bool = False):
    """One autoregressive decode step over a per-layer KV cache: the cache-swap serving surface.

    ``cache_keys`` / ``cache_values`` are (num_layers, num_kv_heads, S,
    head_dim) post-RoPE tensors in ``llama_prefill_kv``'s layout, the true
    cache or any reconstruction of it. ``token_id`` / ``position`` are ints
    (position is the new token's absolute position, normally S), or tensors
    of one batch shape B; the caches may then carry leading dims that
    broadcast to B, (*C, num_layers, ...).

    Returns (h_last (*B, hidden), (k_new, v_new) each (*B, num_layers,
    num_kv_heads, 1, head_dim), attn_entropy (*B, num_layers,
    num_attention_heads) in nats). No LM head: the step stops at the final
    hidden state, before any output norm. ``capture_ffn_input`` appends each
    layer's FFN input (*B, num_layers, 1, hidden), the tensor a sparse-MoE
    router reads; ``capture_sink_mass`` appends, last, each head's sink mass
    (*B, num_layers, num_attention_heads), zeros without ``attn_sinks``.

    With ``shard_llama_params``' params every rank of the mesh calls this with
    the same token and position and passes either the global caches (on the
    mesh's kind of device; it reads its KV heads) or its ``shard_kv_heads``
    shard of them; h comes back whole, and the new rows and the per-head
    outputs gathered over heads, on every rank.
    """
    tp = _layout(params)
    h, k_new, v_new, ent, sink_mass, ffn_x = _decode(config, params, token_id, position, _local_kv(cache_keys, tp),
                                                     _local_kv(cache_values, tp), tp)
    if tp is not None:
        k_new, v_new, ent = tp.gather_kv(k_new, -3), tp.gather_kv(v_new, -3), tp.gather_q(ent, -1)
        sink_mass = tp.gather_q(sink_mass, -1) if capture_sink_mass else sink_mass
    result = [h, (k_new, v_new), ent]
    if capture_ffn_input:
        result.append(ffn_x.unsqueeze(-2))
    if capture_sink_mass:
        result.append(sink_mass)
    return tuple(result)


@torch.no_grad()
def llama_decode_rollout(config: LlamaConfig, params: dict, token_ids, start_position: int, cache_keys,
                         cache_values, forced_keys=None, forced_values=None):
    """T autoregressive decode steps: the serving loop.

    Token t decodes at ``start_position + t`` and its per-layer K/V is
    written IN PLACE into ``cache_keys`` / ``cache_values`` at that row, so
    later tokens attend to it. The caches are pre-allocated (*B, num_layers,
    num_kv_heads, S_buf, head_dim) buffers whose rows [0, start_position)
    hold the prefix (true cache or any reconstruction); S_buf >=
    start_position + T. ``token_ids`` is (*B, T).

    ``forced_keys`` / ``forced_values`` ((*B, T, num_layers, num_kv_heads, 1,
    head_dim)), if given, are written instead of each step's own K/V: the
    rollout-drift study's contamination-control arm, as in the JAX package.

    Returns (h (*B, T, hidden), (keys, values) the filled buffers (the same
    tensors), (k_new, v_new) (*B, T, num_layers, num_kv_heads, 1, head_dim)
    each step's own computed rows, entropy (*B, T, num_layers,
    num_attention_heads)).

    With ``shard_llama_params``' params (every rank calls this alike) each
    step writes its rows into the rank's KV heads of the buffers, the global
    ones or its ``shard_kv_heads`` shard, and gathers nothing of the cache;
    at the end the rows, the entropies and the filled buffers are gathered
    over heads once: into the global buffers, which come back, or as new
    tensors where shards were passed.
    """
    tp = _layout(params)
    ids = torch.as_tensor(np.asarray(token_ids) if not isinstance(token_ids, torch.Tensor) else token_ids)
    batched = ids.dim() > 1
    keys, values = _local_kv(cache_keys, tp), _local_kv(cache_values, tp)
    if batched:
        ids = ids.to(keys.device)
    n_steps = ids.shape[-1]
    if keys.shape[-2] < start_position + n_steps:
        raise ValueError(f"buffer of {keys.shape[-2]} rows cannot take {n_steps} tokens from {start_position}")
    hs, k_news, v_news, ents = [], [], [], []
    axis = ids.dim() - 1
    for t in range(n_steps):
        pos = int(start_position) + t
        tok = ids[..., t] if batched else int(ids[t])
        h, kn, vn, ent, _, _ = _decode(config, params, tok, pos, keys, values, tp)
        ak, av = (kn, vn) if forced_keys is None else (_local_kv(x.select(axis, t), tp)
                                                       for x in (forced_keys, forced_values))
        keys[..., pos:pos + 1, :] = ak
        values[..., pos:pos + 1, :] = av
        hs.append(h), k_news.append(kn), v_news.append(vn), ents.append(ent)
    k_new, v_new, ent = (torch.stack(x, dim=axis) for x in (k_news, v_news, ents))
    if tp is None:
        return torch.stack(hs, dim=axis), (cache_keys, cache_values), (k_new, v_new), ent
    filled = []
    for buffer, local in ((cache_keys, keys), (cache_values, values)):
        whole = tp.gather_kv(local, -3)
        filled.append(whole if isinstance(buffer, LocalShard) else buffer.copy_(whole))
    return (torch.stack(hs, dim=axis), tuple(filled), (tp.gather_kv(k_new, -3), tp.gather_kv(v_new, -3)),
            tp.gather_q(ent, -1))


# ---------------------------------------------------------------------------
# Tensor parallelism: the layout, the shard of the weights and of a cache
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TPLayout:
    """One rank's part of a tensor-parallel Llama (``shard_llama_params``).

    The rank runs query heads [q_heads[0], q_heads[1]) and KV heads
    [kv_heads[0], kv_heads[1]). ``kv_replicas`` is 1 where the KV heads split
    over the ranks; where the ranks outnumber them, each KV head is computed by
    ``kv_replicas`` ranks in a row, the ones whose query heads read it
    (Megatron's KV replication; JAX's GSPMD cuts inside a head there).
    """

    mesh: object
    rank: int
    world: int
    q_heads: tuple[int, int]
    kv_heads: tuple[int, int]
    kv_replicas: int

    @property
    def n_q(self) -> int:
        return self.q_heads[1] - self.q_heads[0]

    @property
    def n_kv(self) -> int:
        return self.kv_heads[1] - self.kv_heads[0]

    @property
    def kv_first(self) -> bool:
        """Whether this rank is the first of its KV heads' holders (always, where they split)."""
        return self.rank % self.kv_replicas == 0

    def check(self) -> None:
        """Refuse a shard made for another rank of another mesh."""
        if (self.rank, self.world) != (self.mesh.get_local_rank(), self.mesh.size()):
            raise ValueError(f"Llama weights sharded for rank {self.rank} of {self.world} were handed to rank "
                             f"{self.mesh.get_local_rank()} of {self.mesh.size()}")

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's partial ``x``, the same bits on every rank."""
        return all_reduce_sum(x, self.mesh)

    def gather_q(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' query-head outputs concatenated along their head ``dim``: every head once, in order."""
        return gather_rows(x, self.mesh, dim)

    def gather_kv(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' KV-head tensors concatenated along their head ``dim``, each head once (a replicated
        head's first holder's), in order."""
        whole = gather_rows(x, self.mesh, dim)
        if self.kv_replicas == 1:
            return whole
        firsts = torch.arange(0, self.world, self.kv_replicas, device=whole.device)
        return whole.index_select(dim, firsts)


def _layout(params: dict) -> TPLayout | None:
    """The params' TP layout (checked against this rank), or None for whole weights."""
    tp = params.get("tp")
    if tp is not None:
        tp.check()
    return tp


def _local_kv(cache, tp: TPLayout | None):
    """This rank's KV heads of a cache (*C, L, n_kv, S, D): the cache itself without TP; a ``shard_kv_heads``
    shard, checked; or a view of the global cache, which must lie on the mesh's kind of device."""
    if tp is None:
        return cache
    if isinstance(cache, LocalShard):
        local = cache.on(tp.mesh)
        if local.shape[-3] != tp.n_kv:
            raise ValueError(f"a cache shard of {local.shape[-3]} KV heads was handed to a rank that runs {tp.n_kv}")
        return local
    check_on_mesh(cache, tp.mesh)
    return cache.narrow(-3, tp.kv_heads[0], tp.n_kv)


def shard_kv_heads(cache, layout: TPLayout) -> LocalShard:
    """This rank's KV heads of a cache or buffer (*C, L, n_kv, S, D), alone on its device, for the decode step and
    the rollout under ``layout`` (``shard_llama_params(...)["tp"]``): JAX's cache placed with
    ``PartitionSpec(None, "tp", None, None)``. ``cache`` may lie on the host (put on the card once here)."""
    layout.check()
    check_on_mesh(cache, layout.mesh, from_host=True)
    cache = torch.as_tensor(cache)
    local = cache.narrow(-3, layout.kv_heads[0], layout.n_kv).contiguous().to(mesh_device(layout.mesh))
    return LocalShard.of(local, layout.mesh)


def shard_llama_params(params: dict, mesh, axis: str | None = "tp", expert_axis: str | None = None, *,
                       config: LlamaConfig) -> dict:
    """Megatron tensor parallelism of a Llama's weights over a mesh (``llama_jax.shard_llama_params``, :1858).

    Every rank calls it with the global ``{"embed", "layers"}`` params, on
    the host (each rank then copies only its leaves to its device) or on the
    mesh's kind of device, and gets this rank's leaves on its device under
    the same names, plus ``"tp"``, its ``TPLayout``. ``config`` gives the
    head geometry: the port cuts at head boundaries. The layout is JAX's:
    q / k / v, their biases and gate / up split their output columns, o and
    down their input rows; ``o_bias`` is replicated and added once after the
    sum; sinks follow the query heads, Cohere's per-head q / k norms their
    heads, OLMo-2's flat q / k norms their columns; Mixtral's and the Qwen
    MoEs' w1 / w3 split their intermediate (last) dim and w2 its
    intermediate dim, the Qwen2-MoE shared expert splits as a dense MLP;
    routers, ``sh_gate``, other norms, the embedding and GPT-OSS's experts
    (whose interleaved gate / up pairs a column split would separate) are
    replicated.

    The query heads must divide over the ranks; the KV heads must divide over
    them or divide their count (then each KV head is replicated on the ranks
    whose query heads read it). ``axis`` names JAX's mesh axis: the port's
    mesh is 1-D, so it is only refused as None. ``expert_axis`` (expert
    parallelism) is not ported: refused on a MoE checkpoint, and on a dense
    one with JAX's error.
    """
    layers = params["layers"]
    if expert_axis is not None:
        if "router" not in layers[0]:
            raise ValueError("expert_axis given but the checkpoint has no MoE leaves (dense MLP — use axis='tp' "
                             "tensor parallelism instead)")
        raise NotImplementedError("expert parallelism (expert_axis) is not ported to PyTorch: it waits for "
                                  "ROADMAP.md queue 1, item 8")
    if axis is None:
        raise NotImplementedError("axis=None (replicated attention for pure expert parallelism) waits with expert "
                                  "parallelism for ROADMAP.md queue 1, item 8")
    if config.qk_norm_full and config.layernorm:
        raise NotImplementedError("a flat q / k LayerNorm has no tensor-parallel form here (no family has one)")
    check_on_mesh(params["embed"], mesh, from_host=True)
    rank, world = mesh.get_local_rank(), mesh.size()
    n_q, n_kv, d = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    check_divisible(n_q, mesh, "query head count")
    if n_kv % world == 0:
        replicas, kv_per = 1, n_kv // world
        kv0 = rank * kv_per
    elif world % n_kv == 0:
        replicas, kv_per = world // n_kv, 1
        kv0 = rank // replicas
    else:
        raise ValueError(f"{n_kv} KV heads neither divide over {world} ranks nor divide their count (Megatron's "
                         "KV replication needs one or the other)")
    q_per = n_q // world
    q0 = rank * q_per
    device = mesh_device(mesh)

    def heads(first, count, dim, width=d):
        return lambda x: x.narrow(dim, first * width, count * width)

    def inner(dim):  # an intermediate dim, split evenly
        def cut(x):
            check_divisible(int(x.shape[dim]), mesh, "intermediate size")
            per = x.shape[dim] // world
            return x.narrow(dim, rank * per, per)
        return cut

    q_cols, kv_cols = heads(q0, q_per, -1), heads(kv0, kv_per, -1)
    rules = {"q": q_cols, "q_bias": q_cols, "k": kv_cols, "k_bias": kv_cols, "v": kv_cols, "v_bias": kv_cols,
             "o": heads(q0, q_per, 0), "sinks": heads(q0, q_per, 0, 1),
             "gate": inner(-1), "up": inner(-1), "down": inner(0), "w1": inner(-1), "w3": inner(-1), "w2": inner(1),
             "sh_w1": inner(-1), "sh_w3": inner(-1), "sh_w2": inner(0)}
    if config.qk_norm_full:  # OLMo-2's flat norms: their columns
        rules.update(q_norm=q_cols, k_norm=kv_cols)
    elif config.qk_norm and config.layernorm:  # Cohere's (heads, head_dim) weights: their heads
        rules.update(q_norm=heads(q0, q_per, 0, 1), k_norm=heads(kv0, kv_per, 0, 1))

    def place(name, x):
        x = torch.as_tensor(x)
        return rules.get(name, lambda y: y)(x).contiguous().to(device)

    layout = TPLayout(mesh, rank, world, (q0, q0 + q_per), (kv0, kv0 + kv_per), replicas)
    return {"embed": place("embed", params["embed"]),
            "layers": [{name: place(name, x) for name, x in lp.items()} for lp in layers], "tp": layout}


# ---------------------------------------------------------------------------
# Weights: the leaves, random init, the HF loader
# ---------------------------------------------------------------------------

_LAYER_MAP = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.o_proj",
              "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}


def layer_shapes(config: LlamaConfig) -> dict[str, tuple]:
    """Every per-layer leaf of the config's parameters, with its shape."""
    h, i_sz, d = config.hidden_size, config.intermediate_size, config.head_dim
    n_q, n_kv = config.num_attention_heads, config.num_key_value_heads
    shapes = {"q": (h, n_q * d), "k": (h, n_kv * d), "v": (h, n_kv * d), "o": (n_q * d, h),
              "q_bias": (n_q * d,), "k_bias": (n_kv * d,), "v_bias": (n_kv * d,), "o_bias": (h,)}
    e = config.num_local_experts
    if not e:
        shapes.update(gate=(h, i_sz), up=(h, i_sz), down=(i_sz, h))
    elif config.moe_style == "gpt_oss":
        shapes.update(router=(h, e), router_bias=(e,), gate_up=(e, h, 2 * i_sz), gate_up_bias=(e, 2 * i_sz),
                      moe_down=(e, i_sz, h), moe_down_bias=(e, h))
    else:
        shapes.update(router=(h, e), w1=(e, h, i_sz), w3=(e, h, i_sz), w2=(e, i_sz, h))
        if config.shared_expert_intermediate_size:
            shi = config.shared_expert_intermediate_size
            shapes.update(sh_w1=(h, shi), sh_w3=(h, shi), sh_w2=(shi, h), sh_gate=(h, 1))
    if config.attn_sinks:
        shapes["sinks"] = (n_q,)
    if not config.norm_after_only:
        shapes["input_norm"] = (h,)
    if not config.parallel_residual:
        shapes["post_norm"] = (h,)
    if config.qk_norm and config.layernorm:  # Cohere: per-head weights
        shapes.update(q_norm=(n_q, d), k_norm=(n_kv, d))
    elif config.qk_norm:
        shapes.update(q_norm=(d,), k_norm=(d,))
    if config.qk_norm_full:
        shapes.update(q_norm=(n_q * d,), k_norm=(n_kv * d,))
    if config.sandwich_norms:
        shapes["pre_ffn_norm"] = (h,)
    if config.sandwich_norms or config.norm_after_only:
        shapes["post_ffn_norm"] = (h,)
    return shapes


def init_random_llama(config: LlamaConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random small-scale weights (tests and studies without a checkpoint), on ``device``
    (``resolve_device``: the GPU unless the caller asks for the CPU).

    Draws from ``np.random.RandomState(seed)`` in the JAX package's order (q,
    k, v, o, gate, up, down, each stacked over layers, even for a MoE config,
    whose dense leaves are then dropped; the router and experts; GPT-OSS's
    sinks and then random attention biases; Cohere's per-head QK-norm
    weights; the embedding last; zero biases and unit norms draw nothing), so
    both packages hold the same numbers. Each stacked draw is taken one layer
    at a time, which gives the same sequence.
    """
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    shapes = layer_shapes(config)
    h, i_sz = config.hidden_size, config.intermediate_size
    layers = [{} for _ in range(config.num_hidden_layers)]

    def draw(name, shape, base=0.0, scale=0.02):
        for lp in layers:
            lp[name] = torch.from_numpy((base + rng.randn(*shape) * scale).astype(np.float32)).to(device, dtype)

    for name in ("q", "k", "v", "o"):
        draw(name, shapes[name])
    for name, shape in (("gate", (h, i_sz)), ("up", (h, i_sz)), ("down", (i_sz, h))):
        draw(name, shape)  # drawn for a MoE config too, as JAX does, then dropped
    moe = ("router", "router_bias", "gate_up", "gate_up_bias", "moe_down", "moe_down_bias", "w1", "w3", "w2",
           "sh_w1", "sh_w3", "sh_w2", "sh_gate")
    for name in moe:
        if name in shapes:
            draw(name, shapes[name])
    for lp in layers:
        for name, shape in shapes.items():
            if name not in lp and name.endswith("bias"):
                lp[name] = torch.zeros(shape, dtype=dtype, device=device)
        if config.num_local_experts:
            del lp["gate"], lp["up"], lp["down"]
    if config.attn_sinks:  # then random attention biases, so tests exercise them
        for name in ("sinks", "q_bias", "k_bias", "v_bias", "o_bias"):
            draw(name, shapes[name])
    if config.qk_norm and config.layernorm:  # Cohere's per-head weights, random so no misbroadcast hides
        draw("q_norm", shapes["q_norm"], 1.0, 0.05)
        draw("k_norm", shapes["k_norm"], 1.0, 0.05)
    for lp in layers:
        for name, shape in shapes.items():
            if name not in lp:  # the norms
                lp[name] = torch.ones(shape, dtype=dtype, device=device)
    embed = torch.from_numpy((rng.randn(config.vocab_size, h) * 0.02).astype(np.float32)).to(device, dtype)
    return {"embed": embed, "layers": [{name: lp[name] for name in shapes} for lp in layers]}


def load_llama_params(model_dir: Path, dtype=torch.bfloat16, device=None) -> tuple[LlamaConfig, dict]:
    """An HF checkpoint directory -> (config, params) on ``device`` (the GPU unless ``"cpu"``), in ``dtype``.

    HF's (out, in) projections become (in, out); fused ``qkv_proj`` (Phi-3)
    and ``gate_up_proj`` (Phi-3, GLM) are split; the Mixtral, Qwen-MoE and
    GPT-OSS expert layouts, the shared expert, sinks and GLM-4's norm names
    map as in the JAX loader; attention biases a checkpoint does not carry
    are zeros. A missing tensor is a ``KeyError``, a leaf of the wrong shape
    a ``ValueError``.
    """
    model_dir = Path(model_dir)
    device = resolve_device(device)
    with open(model_dir / "config.json") as f:
        config = LlamaConfig.from_hf_dict(json.load(f))
    get, names = open_hf_weights(model_dir)
    shapes = layer_shapes(config)

    def arr(name: str, transpose: bool = False) -> torch.Tensor:
        t = get(name).to(device)
        return (t.T if transpose else t).to(dtype).contiguous()

    moe = bool(config.num_local_experts)
    n_q_cols = config.num_attention_heads * config.head_dim
    n_kv_cols = config.num_key_value_heads * config.head_dim
    layers = []
    for i in range(config.num_hidden_layers):
        prefix = f"model.layers.{i}"
        lp: dict[str, torch.Tensor] = {}
        fused_qkv, fused_gate_up = f"{prefix}.self_attn.qkv_proj.weight", f"{prefix}.mlp.gate_up_proj.weight"
        if fused_qkv in names:  # Phi-3: columns q | k | v
            qkv = arr(fused_qkv, transpose=True)
            lp.update(q=qkv[:, :n_q_cols], k=qkv[:, n_q_cols:n_q_cols + n_kv_cols], v=qkv[:, n_q_cols + n_kv_cols:])
        if fused_gate_up in names and not moe:  # Phi-3 and GLM: columns gate | up
            gate_up = arr(fused_gate_up, transpose=True)
            lp.update(gate=gate_up[:, :config.intermediate_size], up=gate_up[:, config.intermediate_size:])
        for short, hf in _LAYER_MAP.items():
            if short not in lp and not (moe and short in ("gate", "up", "down")):
                lp[short] = arr(f"{prefix}.{hf}.weight", transpose=True)
        if moe and config.moe_style == "gpt_oss":  # experts ship stacked and matmul-ready
            lp.update(router=arr(f"{prefix}.mlp.router.weight", transpose=True),
                      router_bias=arr(f"{prefix}.mlp.router.bias"),
                      gate_up=arr(f"{prefix}.mlp.experts.gate_up_proj"),
                      gate_up_bias=arr(f"{prefix}.mlp.experts.gate_up_proj_bias"),
                      moe_down=arr(f"{prefix}.mlp.experts.down_proj"),
                      moe_down_bias=arr(f"{prefix}.mlp.experts.down_proj_bias"))
        elif moe:
            if config.moe_style in ("qwen3_moe", "qwen2_moe"):
                block, names_map = "mlp", {"w1": "gate_proj", "w2": "down_proj", "w3": "up_proj"}
            else:
                block, names_map = "block_sparse_moe", {"w1": "w1", "w2": "w2", "w3": "w3"}
            lp["router"] = arr(f"{prefix}.{block}.gate.weight", transpose=True)
            for wn in ("w1", "w2", "w3"):
                lp[wn] = torch.stack([arr(f"{prefix}.{block}.experts.{j}.{names_map[wn]}.weight", transpose=True)
                                      for j in range(config.num_local_experts)])
            if config.shared_expert_intermediate_size:
                for ours, hf in (("sh_w1", "gate_proj"), ("sh_w3", "up_proj"), ("sh_w2", "down_proj")):
                    lp[ours] = arr(f"{prefix}.mlp.shared_expert.{hf}.weight", transpose=True)
                lp["sh_gate"] = arr(f"{prefix}.mlp.shared_expert_gate.weight", transpose=True)
        if config.attn_sinks:
            lp["sinks"] = arr(f"{prefix}.self_attn.sinks")
        for bk in ("q_bias", "k_bias", "v_bias", "o_bias"):
            name = f"{prefix}.{_LAYER_MAP[bk[0]]}.bias"
            lp[bk] = arr(name) if name in names else torch.zeros(shapes[bk], dtype=dtype, device=device)
        if not config.norm_after_only:
            lp["input_norm"] = arr(f"{prefix}.input_layernorm.weight")
        # GLM-4 names gemma2's sandwich otherwise: post_self_attn_layernorm is the attention-output norm,
        # post_attention_layernorm the pre-FFN norm, post_mlp_layernorm the FFN-output norm.
        glm4_post = f"{prefix}.post_self_attn_layernorm.weight"
        if not config.parallel_residual:
            lp["post_norm"] = arr(glm4_post if glm4_post in names else f"{prefix}.post_attention_layernorm.weight")
        if config.qk_norm or config.qk_norm_full:
            lp["q_norm"] = arr(f"{prefix}.self_attn.q_norm.weight")
            lp["k_norm"] = arr(f"{prefix}.self_attn.k_norm.weight")
        if config.sandwich_norms:
            lp["pre_ffn_norm"] = arr(f"{prefix}.post_attention_layernorm.weight" if glm4_post in names
                                     else f"{prefix}.pre_feedforward_layernorm.weight")
        if config.sandwich_norms or config.norm_after_only:
            lp["post_ffn_norm"] = arr(f"{prefix}.post_mlp_layernorm.weight" if glm4_post in names
                                      else f"{prefix}.post_feedforward_layernorm.weight")
        for name, want in shapes.items():
            if tuple(lp[name].shape) != want:
                raise ValueError(f"{prefix} {name}: shape {tuple(lp[name].shape)}, the config needs {want}")
        layers.append({name: lp[name].contiguous() for name in shapes})
    embed = arr("model.embed_tokens.weight")
    if tuple(embed.shape) != (config.vocab_size, config.hidden_size):
        raise ValueError(f"embed_tokens: shape {tuple(embed.shape)}, the config needs "
                         f"{(config.vocab_size, config.hidden_size)}")
    return config, {"embed": embed, "layers": layers}


def prefill_and_save_kv(config: LlamaConfig, params: dict, input_ids, output_dir: Path,
                        model_name: str, seq_mesh=None) -> KVMetadata:
    """One prefill of token ids and its per-layer KV in the standard layout (``metadata.json`` and one npz a layer).

    The port of ``llama_jax.prefill_and_save_kv`` (:1972). ``seq_mesh``: run
    the prefill sequence-parallel over this mesh (``llama_prefill_kv_sp``;
    every rank calls this with the same ids): the ids are END-padded to a
    multiple of the mesh and the cache sliced back, exact because under a
    causal mask trailing pad rows cannot reach an earlier row's K/V. With
    ``shard_llama_params``' params the prefill is tensor-parallel over their
    mesh (every rank calls this alike), the K/V gathered over heads. On a
    mesh rank 0 alone writes, the other ranks wait for it.
    """
    ids = np.asarray(input_ids)
    n = int(len(ids))
    tp = params.get("tp")
    if seq_mesh is None:
        keys, values = llama_prefill_kv(config, params, ids)
    else:
        padded = np.pad(ids, (0, pad_to_multiple(n, seq_mesh.size()) - n))
        keys, values = (x[:, :, :n] for x in llama_prefill_kv_sp(config, params, padded, seq_mesh))
    mesh = seq_mesh if tp is None else tp.mesh
    metadata = KVMetadata(model_name=str(model_name), num_layers=config.num_hidden_layers,
                          num_kv_heads=config.num_key_value_heads, seq_len=n, head_dim=config.head_dim,
                          actual_tokens=n)
    if mesh is None or mesh.get_local_rank() == 0:
        keys = keys.float().cpu().numpy()
        values = values.float().cpu().numpy()
        output_dir = Path(output_dir)
        for layer_idx in range(config.num_hidden_layers):
            kvstore.save_layer(output_dir, layer_idx, keys[layer_idx], values[layer_idx])
        kvstore.save_metadata(output_dir, metadata)
    if mesh is not None:
        barrier(mesh)
    return metadata


def load_for_extraction(model_dir, dtype, device, state: dict | None, loader, mesh=None) -> dict:
    """``state`` holding ``config``, ``params`` and ``tokenizer`` of ``model_dir``: loaded once per directory, dtype,
    device and weight ``mesh`` (the mesh object itself, as JAX keys it; the JAX extractors' reuse contract), the
    tokenizer first so a refused one costs no weight IO."""
    state = state if state is not None else {}
    key = (str(model_dir), str(dtype), str(device))
    if state.get("model_dir") != key or state.get("mesh") is not mesh:
        print(f"Loading {model_dir} into PyTorch ({device})...")
        tokenizer = load_tokenizer(model_dir)
        config, params = loader(Path(model_dir), dtype=dtype, device=device)
        state.update(model_dir=key, mesh=mesh, config=config, params=params, tokenizer=tokenizer)
    return state


def _load_tp_shard(model_dir: Path, dtype, device, mesh) -> tuple[LlamaConfig, dict]:
    """A checkpoint read on the host, then this rank's ``shard_llama_params`` leaves put on its device (the whole
    model never lands on one card)."""
    config, params = load_llama_params(model_dir, dtype=dtype, device="cpu")
    return config, shard_llama_params(params, mesh, config=config)


def extract_kv_with_llama(model_dir, seq_len: int, output_dir: Path, text: str, dtype=torch.bfloat16,
                          state: dict | None = None, device=None, seq_mesh=None, mesh=None) -> KVMetadata:
    """Tokenize ``text`` (at most ``seq_len`` ids), prefill, and persist per-layer K/V in the standard layout.

    The port of ``llama_jax.extract_kv_with_jax_llama`` (:2025) on one device
    (the GPU unless ``"cpu"``); with ``seq_mesh`` sequence-parallel over its
    ranks (each rank calls this and loads the weights onto its own device,
    the mesh's); with ``mesh`` tensor-parallel (``shard_llama_params``: each
    rank reads the checkpoint on the host and puts its own columns on its
    device). On a mesh rank 0 writes. ``state``: pass the same dict across
    calls to load the checkpoint and tokenizer once, as the scaling and
    multi-prompt ladders do. The metadata's ``model_name`` is ``str(model_dir)``.
    """
    if seq_mesh is not None and mesh is not None:
        raise ValueError("mesh (TP) and seq_mesh (SP) are mutually exclusive")
    ranks = seq_mesh if seq_mesh is not None else mesh
    device = resolve_device(device) if ranks is None else mesh_device(ranks, device)
    loader = load_llama_params if mesh is None else functools.partial(_load_tp_shard, mesh=mesh)
    state = load_for_extraction(model_dir, dtype, device, state, loader, mesh=mesh)
    ids = np.asarray(state["tokenizer"](text, truncation=True, max_length=seq_len)["input_ids"])
    print(f"Sequence length: {len(ids)} tokens")
    print("Running prefill..." if ranks is None else
          f"Running prefill, {'sequence' if mesh is None else 'tensor'}-parallel over {ranks.size()} ranks...")
    metadata = prefill_and_save_kv(state["config"], state["params"], ids, output_dir, model_dir, seq_mesh=seq_mesh)
    print(f"Saved {state['config'].num_hidden_layers} layers to {output_dir}/")
    return metadata
