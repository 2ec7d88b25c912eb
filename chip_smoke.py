#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_attention_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phase by phase, each printing its seconds; any failure exits non-zero:

  1. device   the card, its power limit, torch and CUDA versions (no GPU: exit 1)
  2. build    every CUDA kernel from nerf_attention_tpu_torch/csrc with nvcc,
              one nvcc per source, all started together
  3. kernels  each kernel against its plain PyTorch version at the main paths'
              shapes (sweep and decode: S=2048, D=128; 2A at all 7 configs,
              N=40, exact and fast sine, at the plan path's 128 `small`
              nets with S=512, and at S=300 with FM x64; attention: 8 heads,
              medium nets, S=2048 and 32768, T=1, and T=16 causal, exact sine,
              FM x64, ragged S=300; 2C also at 8 heads, fast sine, each S of
              the ladder), with the tolerances of the CPU tests, and
              its time beside the plain version's; one short training run on
              the GPU against the same run on the CPU
  4. sweep    the sweep path: synthetic cache (S=2048, D=128, layers
              0/8/16/24/31 of 32, 8 heads) -> the 280-fit sweep of all 7
              configs, at 200 epochs instead of 2000 to save time
  5. latency  profile_latency on 8 medium checkpoints: fused decode against a
              measured bf16 read of the same slice
  6. launches every kernel of the sweep path was launched by phases 4-5
              (counters zeroed before 4)
  7. ladder   the attention-decode path: the ladder tool over S=2048, 8192,
              32768 at full width (8 heads, D=128, medium), all five legs
              and three quantized schemes
  8. launches every kernel of the attention path (2C, 2D, 2F, 2I) was
              launched by phase 7 (counters zeroed just before it)
  9. determinism  the medium group twice for 50 epochs, and kernels 2A (large,
              N=40), 2D, 2F, 2I, 2G, 2H and 2E twice on the same inputs:
              bit-identical
 10. mla      the MLA decode path: the MLA ladder tool at DeepSeek-V2-Lite's
              widths (H=16, kv_lora_rank 512, rope 64, hidden 2048, dense FFN
              10944, bf16, YaRN rope scaling), S=1024/4096/16384/32768, all
              legs and schemes int8_g32, int4_g64; cut to 4 dense layers and
              a 4096-row vocabulary (the step reads one embedding row, no LM
              head)
 11. launches kernels 2G and 2H were launched by phase 10 (counters zeroed
              just before it); the ladder's JSON: finite medians, the legs'
              output cosines
 12. moe      one absorbed step through 2G on a V2-Lite-shaped 2-layer stack
              (1 dense layer, then 64 routed experts, top-6, 2 shared, width
              1408) against the same step through the plain attention
 13. plan     the serve-plan rollout path: the plan-rollout tool at
              Llama-3.1-8B's widths (hidden 4096, 32 query / 8 KV heads,
              head_dim 128, FFN 14336, llama3 rope), random weights from seed
              0 with the tool's head gains, the tool's defaults (S=512, 64
              tokens, budgets 0.003/0.01/0.03, master/int8_g32/int4_g128,
              `small` nets, 2000 epochs); cut to 8 layers of 32, a 4096-row
              vocabulary of 128256 (a step reads one embedding row, no LM
              head) and one seed of three
 14. launches kernels 2A, 2C and 2E were launched by phase 13 (counters zeroed
              just before it); its JSON: finite costs and tokens/s, n_served
              rising with the budget, measured/predicted within 0.1-10, int4
              payloads smaller than int8 ones for the same units

Phase 3 also holds kernels 2G and 2H (H=16, r=512, rope 64; S_buf 1024,
32768, 300 and 0; the logit scale with and without YaRN's mscale^2) to
their plain versions, and 2H to 2G on the host-dequantized latent (max abs
diff 0); and kernel 2E (128 `small` nets, S=512, D=128, int8_g32 and
int4_g128, fast sine, as the plan path runs it; S=300 with FM x32 in five
schemes) to its plain version, and to 2C on the host-dequantized weights
(max abs diff 0). Each kernel's time at the main path's shapes stands beside its
plain version's, its bound (the larger of its bytes at 3.35 TB/s and its
operations at the peak for their operand type: 67 TFLOP/s fp32, 989 TFLOP/s
bf16 and 495 TFLOP/s TF32 on the tensor cores (2A: 3xTF32 counted as one pass,
the three-pass floor printed beside it); from this run's shapes) and, where one PyTorch
call computes the same function, that call's time (library_ms; the port
never calls it).

It ends with the kernels' JSON line, the nvidia-smi line and the JSON result.
The TPU package is not imported.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEQ_LEN, HEAD_DIM, N_FITS = 2048, 128, 40
SWEEP_EPOCHS = 200
NUM_LAYERS, NUM_HEADS, SWEEP_LAYERS = 32, 8, [0, 8, 16, 24, 31]

# Tolerances of the CPU tests (tests/test_torch_siren_decode.py,
# tests/test_torch_siren_train.py).
DECODE_TOL = dict(rtol=1e-5, atol=2e-5)
TRAIN_TOL = {
    "exact": dict(loss=dict(rtol=1e-5, atol=1e-6), grads=dict(rtol=1e-4, atol=1e-6)),
    "fast": dict(loss=dict(rtol=1e-3, atol=1e-5), grads=dict(rtol=1e-3, atol=1e-5)),
    "fm": dict(loss=dict(rtol=1e-3, atol=1e-4), grads=dict(rtol=1e-3, atol=1e-4)),
}
FM_MULT = 64.0
# tests/test_torch_siren_attention.py and tests/test_torch_kv_quant.py
ATTN_TOL = dict(rtol=1e-4, atol=5e-5)
KV_TOL = dict(rtol=1e-4, atol=2e-5)
LOGZ_ATOL = 1e-4  # the log-partition m + log l of the (m, l) stats
ATTN_SEQ_LENS = (2048, 32768)
SCHEMES = ("int8_g32", "int6_g64", "int4_g128")
LIBRARIES = ("siren_decode", "siren_train", "siren_attention", "kv_quant_attention", "mla_absorbed_attention",
             "siren_decode_quant")

# H100 SXM data sheet: fp32 outside the tensor cores, bf16 and TF32 on the tensor cores (dense), device memory.
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12
PEAK_TF32_FLOPS = 495e12
TRAIN_SIMT_MS = 10.4799  # kernel 2A's earlier fp32 SIMT version: medium, N=40, S=2048 (PERF.md §6)

# The MLA slice: DeepSeek-V2-Lite's attention (huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json).
MLA_H, MLA_R, MLA_ROPE = 16, 512, 64
MLA_D = MLA_R + MLA_ROPE
MLA_SCALE = (128 + MLA_ROPE) ** -0.5  # qk_head_dim ** -0.5
# DeepSeek's own V2 code also multiplies the logit scale by YaRN's mscale^2 (factor 40, mscale_all_dim 0.707:
# 1.59x); the reference (mla_jax.py MLAConfig.attn_scale) does so for V3 only. The kernels are held at both.
MLA_SCALES = (MLA_SCALE, MLA_SCALE * (0.1 * 0.707 * math.log(40) + 1.0) ** 2)
MLA_SEQ_LENS = (1024, 32768, 300, 0)
MLA_SCHEMES = ("int8_g32", "int6_g64", "int4_g64")
MLA_LADDER = (1024, 4096, 16384, 32768)
MLA_LADDER_SCHEMES = ("int8_g32", "int4_g64")
MLA_TOL = dict(rtol=1e-5, atol=2e-5)  # tests/test_torch_cuda.py: fp32 sums in another order
# bf16: the kernel rounds each softmax weight relative to its 32-row tile's
# running max, the plain version relative to the global max (2^-9 of each
# weight). The errors of many weights mostly cancel, so o_lat's error is held
# to this share of the case's own largest |o_lat| (at most 3.0e-3 measured).
MLA_BF16_REL = 1e-2
# The JAX records read 0.99987-0.99989 for the bf16 pairs and 0.9981 for int4_g64
# (benchmarks/r4/mla_absorbed_decode.json, benchmarks/r5/mla_quant/mla_absorbed_decode.json).
MLA_COS_FLOOR = {"cos_absorbed_vs_materialized": 0.999, "cos_absorbed_vs_latent_remat": 0.999,
                 "cos_pallas_vs_absorbed": 0.999}
MLA_QUANT_COS_FLOOR = {"int8_g32": 0.999, "int4_g64": 0.995}
V2_LITE = dict(  # DeepSeek-V2-Lite config.json, vocabulary cut to 4096
    model_type="deepseek_v2", vocab_size=4096, hidden_size=2048, intermediate_size=10944,
    num_attention_heads=16, kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, first_k_dense_replace=1, n_routed_experts=64, num_experts_per_tok=6,
    n_shared_experts=2, moe_intermediate_size=1408, topk_method="greedy", n_group=1, topk_group=1,
    routed_scaling_factor=1.0, norm_topk_prob=False, rope_theta=10000, max_position_embeddings=163840,
    rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                  "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096},
)


# The plan-rollout slice: Llama-3.1-8B (huggingface.co/meta-llama/Llama-3.1-8B config.json), cut to 8 layers
# (the JAX tool's depth) and a 4096-row vocabulary.
LLAMA_31_8B = dict(
    model_type="llama", vocab_size=4096, hidden_size=4096, intermediate_size=14336, num_hidden_layers=8,
    num_attention_heads=32, num_key_value_heads=8, head_dim=128, hidden_act="silu", rms_norm_eps=1e-5,
    rope_theta=500000.0, max_position_embeddings=131072, attention_bias=False, mlp_bias=False,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
)
PLAN_CUTS = ["layers 8 of 32", "vocabulary 4096 of 128256 (a step reads one embedding row; no LM head)",
             "seeds 1 of 3 (seed 0)"]
PLAN_SEQ_LEN, PLAN_NETS = 512, 128  # the tool's S; 2 x 64 units, the most nets a recon leg decodes
DECODE_QUANT_SCHEMES = ("int8_g32", "int6_g64", "int4_g128", "int4_g32", "int8_g32_l0fp32")


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.2f}s", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak for their operand type."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def siren_macs(dims) -> tuple[int, int]:
    """(multiply-adds per position, parameter bytes) of one fp32 SIREN."""
    return sum(i * o for i, o in dims), 4 * sum(i * o + o for i, o in dims)


def errors(got, want) -> tuple[float, float]:
    """(max abs error, max error relative to the largest |want|)."""
    diff = (got - want).abs().max().item()
    return diff, diff / max(want.abs().max().item(), 1e-30)


def check_close(what: str, got, want, rtol: float, atol: float) -> float:
    import torch

    abs_err, rel_err = errors(got, want)
    print(f"  {what}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} (rtol={rtol}, atol={atol})")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return abs_err


def attention_inputs(n: int, t: int, dev, seed: int):
    """Key and value stacks of n medium nets (D=128), their denormalization
    stats and T queries, made from a seed as the ladder tool makes them."""
    import torch

    from nerf_attention_tpu_torch.tools import measure_attention_decode
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    return measure_attention_decode.attention_inputs(CONFIGS_BY_NAME["medium"], n, t, HEAD_DIM,
                                                     torch.Generator().manual_seed(seed), dev)


def random_cache(n: int, seq_len: int, t: int, dev, seed: int):
    """Random K and V halves (n, S, D) and T queries per unit."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    k, v = (torch.randn(n, seq_len, HEAD_DIM, generator=gen).to(dev) for _ in range(2))
    return k, v, (torch.randn(n, t, HEAD_DIM, generator=gen) * 0.4).to(dev)


def check_attention_kernels(dev, median_ms) -> dict:
    """Kernels 2D, 2F and 2I against their plain versions; their report entries."""
    import torch

    from nerf_attention_tpu_torch.models.siren import SirenStack
    from nerf_attention_tpu_torch.ops import kv_quant_cuda as kq
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    omega = 30.0
    err = {"siren_attention_decode_fused": 0.0, "siren_attention_decode_quant": 0.0,
           "kv_cache_attention_quant": 0.0}
    cases = [(s, 1, "fast", None, False) for s in ATTN_SEQ_LENS] + [
        (2048, 16, "fast", None, True), (2048, 1, "exact", None, False),
        (2048, 1, "fast", FM_MULT, False), (300, 16, "fast", None, True),
    ]
    for seq_len, t, sin_impl, fm, causal in cases:
        k, v, stats, q = attention_inputs(NUM_HEADS, t, dev, seed=seq_len + t)
        kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal)
        tag = f"N={NUM_HEADS} S={seq_len} T={t} {sin_impl} fm={fm} causal={causal}"
        got = sa.siren_attention_decode_fused(k, v, *stats, q, omega, seq_len, **kw)
        want = sa.siren_attention_decode_plain(k, v, *stats, q, omega, seq_len, **kw)
        torch.cuda.synchronize()
        err["siren_attention_decode_fused"] = max(err["siren_attention_decode_fused"],
                                                  check_close(f"2D {tag}", got, want, **ATTN_TOL))
        for sch in SCHEMES if t == 1 and sin_impl == "fast" and fm is None else SCHEMES[-1:]:
            packed = (sq.pack_resident_params(k.params(), sch), sq.pack_resident_params(v.params(), sch))
            o, m, l = sq.siren_attention_decode_quant(None, None, *stats, q, sch, omega, seq_len, packed=packed,
                                                      return_stats=True, **kw)
            want_o, want_m, want_l = sq.siren_attention_decode_quant_plain(packed, *stats, q, omega, seq_len,
                                                                           return_stats=True, **kw)
            torch.cuda.synchronize()
            e = check_close(f"2F[{sch}] {tag}", o, want_o, **ATTN_TOL)
            e = max(e, check_close(f"2F[{sch}] {tag} log-partition", m + torch.log(l),
                                   want_m + torch.log(want_l), rtol=0, atol=LOGZ_ATOL))
            err["siren_attention_decode_quant"] = max(err["siren_attention_decode_quant"], e)
            dequant = [SirenStack.from_params(sq.unpack_resident_params(*p)) for p in packed]
            fused = sa.siren_attention_decode_fused(*dequant, *stats, q, omega, seq_len, **kw)
            diff = (o - fused).abs().max().item()
            print(f"  2F[{sch}] {tag} vs 2D on the host-dequantized weights: max_abs_diff={diff:.3e} (must be 0)")
            assert diff == 0.0, diff

    for seq_len in (*ATTN_SEQ_LENS, 300):
        for t in (1, 16):
            ck, cv, q = random_cache(NUM_HEADS, seq_len, t, dev, seed=seq_len + t)
            for sch in SCHEMES:
                pk, pv = kq.pack_kv_unit_stack(ck, sch), kq.pack_kv_unit_stack(cv, sch)
                for pos in (seq_len, seq_len - 37, 1):
                    tag = f"2I[{sch}] N={NUM_HEADS} S={seq_len} T={t} position={pos}"
                    o, m, l = kq.kv_cache_attention_quant(q, pk, pv, pos, scale=HEAD_DIM ** -0.5, return_stats=True)
                    want_o, want_m, want_l = kq.kv_cache_attention_quant_plain(q, pk, pv, pos, scale=HEAD_DIM ** -0.5,
                                                                               return_stats=True)
                    torch.cuda.synchronize()
                    e = check_close(tag, o, want_o, **KV_TOL)
                    e = max(e, check_close(f"{tag} log-partition", m + torch.log(l), want_m + torch.log(want_l),
                                           rtol=0, atol=LOGZ_ATOL))
                    err["kv_cache_attention_quant"] = max(err["kv_cache_attention_quant"], e)
                o, m, l = kq.kv_cache_attention_quant(q, pk, pv, 0, scale=HEAD_DIM ** -0.5, return_stats=True)
                torch.cuda.synchronize()
                zero = (torch.equal(o, torch.zeros_like(o)) and torch.equal(l, torch.zeros_like(l))
                        and bool(torch.isfinite(m).all()))
                print(f"  2I[{sch}] N={NUM_HEADS} S={seq_len} T={t} position=0: o == 0, l == 0, finite = {zero}")
                assert zero

    # Times at the ladder's first point: 8 heads, S=2048, T=1, fast sine, full window.
    report = {}
    seq_len, sch = ATTN_SEQ_LENS[0], SCHEMES[-1]
    shape = f"medium, N={NUM_HEADS}, S={seq_len}, D={HEAD_DIM}, T=1, fast sine"
    k, v, stats, q = attention_inputs(NUM_HEADS, 1, dev, seed=1)
    kw = dict(sin_impl="fast", causal=False)
    packed = (sq.pack_resident_params(k.params(), sch), sq.pack_resident_params(v.params(), sch))
    ck, cv, cq = random_cache(NUM_HEADS, seq_len, 1, dev, seed=2)
    pk, pv = kq.pack_kv_unit_stack(ck, sch), kq.pack_kv_unit_stack(cv, sch)
    runs = {
        "siren_attention_decode_fused": (
            lambda: sa.siren_attention_decode_fused(k, v, *stats, q, omega, seq_len, **kw),
            lambda: sa.siren_attention_decode_plain(k, v, *stats, q, omega, seq_len, **kw), shape),
        "siren_attention_decode_quant": (
            lambda: sq.siren_attention_decode_quant(None, None, *stats, q, sch, omega, seq_len, packed=packed, **kw),
            lambda: sq.siren_attention_decode_quant_plain(packed, *stats, q, omega, seq_len, **kw),
            f"{shape}, {sch} weights"),
        "kv_cache_attention_quant": (
            lambda: kq.kv_cache_attention_quant(cq, pk, pv, seq_len, scale=HEAD_DIM ** -0.5),
            lambda: kq.kv_cache_attention_quant_plain(cq, pk, pv, seq_len, scale=HEAD_DIM ** -0.5),
            f"N={NUM_HEADS}, S={seq_len}, D={HEAD_DIM}, T=1, {sch} K/V, position S"),
    }
    # Bounds: the nets' multiply-adds (sines not counted) and the attention's, or the packed bytes.
    macs, pbytes = siren_macs(k.dims)
    small = 6 * NUM_HEADS * HEAD_DIM * 4  # stats, q and out at T=1
    attn_flops = NUM_HEADS * (2 * 2 * macs * seq_len + 4 * seq_len * HEAD_DIM)
    extra = {
        "siren_attention_decode_fused": dict(**bound(attn_flops, 2 * NUM_HEADS * pbytes + small), library_ms=None),
        "siren_attention_decode_quant": dict(
            **bound(attn_flops, sum(sq.resident_param_bytes(p[0]) for p in packed) + small), library_ms=None),
        "kv_cache_attention_quant": dict(
            **bound(4 * NUM_HEADS * seq_len * HEAD_DIM,
                    kq.resident_kv_bytes(pk[0]) + kq.resident_kv_bytes(pv[0]) + 2 * NUM_HEADS * HEAD_DIM * 4),
            library_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                cq, ck, cv, scale=HEAD_DIM ** -0.5), 50)),  # SDPA over the fp32 cache
    }
    for name, (run, plain, what) in runs.items():
        report[name] = dict(max_abs_err=err[name], ms=median_ms(run, 50), plain_ms=median_ms(plain, 50), shape=what,
                            **extra[name])
        print(f"  {name} ({what}): kernel {report[name]['ms']:.4f} ms, plain {report[name]['plain_ms']:.4f} ms, "
              f"bound {report[name]['bound_ms']:.4f} ms ({report[name]['bound_by']}), "
              f"library {report[name]['library_ms']}")
    return report


def mla_inputs(s_buf: int, dev, seed: int):
    """H absorbed queries, an (S_buf, 576) latent and the new token's row, from a seed."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(MLA_H, MLA_D, generator=gen) * 0.1).to(dev)
    return q, torch.randn(s_buf, MLA_D, generator=gen).to(dev), torch.randn(1, MLA_D, generator=gen).to(dev)


def mla_bytes_small() -> int:
    """q, the new row, o_lat and the entropies (fp32)."""
    return 4 * (MLA_H * MLA_D + MLA_D + MLA_H * MLA_R + MLA_H)


def check_mla_kernels(dev, median_ms) -> dict:
    """Kernels 2G and 2H against their plain versions, 2H against 2G on the
    host-dequantized latent; their report entries (times at S=32768)."""
    import torch

    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma
    from nerf_attention_tpu_torch.ops import mla_quant_cuda as mq

    err = {"mla_absorbed_attention": 0.0, "mla_absorbed_attention_quant": 0.0}
    for s_buf, scale in [(s, MLA_SCALES[0]) for s in MLA_SEQ_LENS] + [(s, MLA_SCALES[1]) for s in MLA_SEQ_LENS[:2]]:
        args = dict(kv_lora_rank=MLA_R, scale=scale)
        q, lat, new = mla_inputs(s_buf, dev, seed=s_buf)
        positions = sorted(p for p in {s_buf, s_buf - 37, 1, 0} if 0 <= p <= s_buf)
        for dtype in (torch.float32, torch.bfloat16):
            cache = lat.to(dtype)
            for pos in positions:
                tag = f"2G {str(dtype)[6:]} H={MLA_H} S_buf={s_buf} position={pos} scale={scale:.5f}"
                o, ent = ma.mla_absorbed_attention(q, cache, new, pos, **args)
                want_o, want_ent = ma.mla_absorbed_attention_plain(q, cache, new, pos, **args)
                torch.cuda.synchronize()
                tol = MLA_TOL if dtype == torch.float32 else dict(rtol=0, atol=MLA_BF16_REL * want_o.abs().max().item())
                e = check_close(f"{tag} o_lat", o, want_o, **tol)
                e = max(e, check_close(f"{tag} entropy", ent, want_ent, **MLA_TOL))
                err["mla_absorbed_attention"] = max(err["mla_absorbed_attention"], e)
        if s_buf == 0:
            continue  # an empty cache has nothing to pack
        for sch in MLA_SCHEMES:
            packed = mq.pack_resident_latent(lat, sch)
            dequant = mq.unpack_resident_latent(*packed)
            for pos in positions:
                tag = f"2H[{sch}] H={MLA_H} S_buf={s_buf} position={pos} scale={scale:.5f}"
                o, ent = mq.mla_absorbed_attention_quant(q, packed, new, pos, **args)
                want_o, want_ent = mq.mla_absorbed_attention_quant_plain(q, packed, new, pos, **args)
                torch.cuda.synchronize()
                e = check_close(f"{tag} o_lat", o, want_o, **MLA_TOL)
                e = max(e, check_close(f"{tag} entropy", ent, want_ent, **MLA_TOL))
                err["mla_absorbed_attention_quant"] = max(err["mla_absorbed_attention_quant"], e)
                o_2g, ent_2g = ma.mla_absorbed_attention(q, dequant, new, pos, **args)
                diff = max((o - o_2g).abs().max().item(), (ent - ent_2g).abs().max().item())
                print(f"  {tag} vs 2G on the host-dequantized latent: max_abs_diff={diff:.3e} (must be 0)")
                assert diff == 0.0, diff

    # Times at the ladder's longest cache, position S: 2G over the bf16 latent, 2H over int4_g64 codes.
    args = dict(kv_lora_rank=MLA_R, scale=MLA_SCALE)
    s_buf = MLA_LADDER[-1]
    q, lat, new = mla_inputs(s_buf, dev, seed=1)
    cache = lat.to(torch.bfloat16)
    packed = mq.pack_resident_latent(lat, "int4_g64")
    flops = 2 * MLA_H * (s_buf + 1) * (MLA_D + MLA_R)
    # The library yardstick: SDPA of the 16 heads (as 16 query rows) over the latent rows, o_lat only
    # (no entropy, no self row).
    q_sdpa = q.to(torch.bfloat16).view(1, 1, MLA_H, MLA_D)
    k_sdpa, v_sdpa = cache.view(1, 1, s_buf, MLA_D), cache[:, :MLA_R].contiguous().view(1, 1, s_buf, MLA_R)
    runs = {
        "mla_absorbed_attention": (
            lambda: ma.mla_absorbed_attention(q, cache, new, s_buf, **args),
            lambda: ma.mla_absorbed_attention_plain(q, cache, new, s_buf, **args),
            # bf16 operands (q, the weights and the cache rounded to bf16), fp32 sums: the tensor cores' type.
            bound(flops, s_buf * MLA_D * 2 + mla_bytes_small(), PEAK_BF16_FLOPS),
            median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q_sdpa, k_sdpa, v_sdpa,
                                                                               scale=MLA_SCALE), 50),
            f"H={MLA_H}, r={MLA_R}, rope={MLA_ROPE}, S_buf={s_buf}, position S, bf16 latent"),
        "mla_absorbed_attention_quant": (
            lambda: mq.mla_absorbed_attention_quant(q, packed, new, s_buf, **args),
            lambda: mq.mla_absorbed_attention_quant_plain(q, packed, new, s_buf, **args),
            bound(flops, mq.resident_latent_bytes(packed[0]) + mla_bytes_small()),  # fp32 throughout
            None,
            f"H={MLA_H}, r={MLA_R}, rope={MLA_ROPE}, S_buf={s_buf}, position S, int4_g64 latent"),
    }
    report = {}
    for name, (run, plain, bnd, library_ms, what) in runs.items():
        report[name] = dict(max_abs_err=err[name], ms=median_ms(run, 50), plain_ms=median_ms(plain, 20), shape=what,
                            library_ms=library_ms, **bnd)
        print(f"  {name} ({what}): kernel {report[name]['ms']:.4f} ms, plain {report[name]['plain_ms']:.4f} ms, "
              f"bound {report[name]['bound_ms']:.4f} ms ({report[name]['bound_by']}), library {library_ms}")
    return report


def check_mla_ladder(payload: dict) -> None:
    """The MLA ladder's JSON: the JAX tool's keys, finite medians, the legs' cosines."""
    legs = ["materialized", "latent_remat", "absorbed", "absorbed_pallas",
            *(f"absorbed_quant_{s}" for s in MLA_LADDER_SCHEMES)]
    row_keys = {"seq_len", "cache_bytes", "hbm_floor_ms", "step_ms", "device_ms", "speedup_absorbed_over",
                "speedup_pallas_over"}
    assert {"geometry", "backend", "protocol", "ladder", "parity", "hbm_read_gbps"} <= payload.keys()
    assert [r["seq_len"] for r in payload["ladder"]] == list(MLA_LADDER)
    assert payload["geometry"]["rope_scaling"] == V2_LITE["rope_scaling"], payload["geometry"]
    print(f"  rope scaling {payload['geometry']['rope_scaling']['type']}, logit scale "
          f"{payload['geometry']['attn_scale']:.6f} (the reference's V2 rule: qk_head_dim ** -0.5)")
    print(f"  measured read rate {payload['hbm_read_gbps']:.1f} GB/s ({payload['hbm_read_source']})")
    print("  S      " + "  ".join(f"{leg:>22}" for leg in legs) + "   latent floor ms")
    for r in payload["ladder"]:
        assert r.keys() == row_keys, r.keys() ^ row_keys
        assert list(r["step_ms"]) == legs, list(r["step_ms"])
        medians = [r["step_ms"][leg]["median"] for leg in legs]
        assert all(math.isfinite(x) and x > 0 for x in medians), medians
        print(f"  {r['seq_len']:<6} " + "  ".join(f"{x:22.4f}" for x in medians)
              + f"   {r['hbm_floor_ms']['latent']:.4f}")
        print("  device " + "  ".join(f"{x:22.4f}" if x is not None else f"{'not measured':>22}"
                                      for x in (r["device_ms"][leg] for leg in legs)))
        print(f"         bytes: " + ", ".join(f"{k} {v}" for k, v in r["cache_bytes"].items()))
    parity = payload["parity"]
    for key, floor in MLA_COS_FLOOR.items():
        print(f"  parity at S={parity['seq_len']}: {key} = {parity[key]:.6f} (>= {floor})")
        assert parity[key] >= floor, (key, parity[key])
    for sch, floor in MLA_QUANT_COS_FLOOR.items():
        cos = parity["quant_resident"][sch]["cos_vs_absorbed"]
        print(f"  parity at S={parity['seq_len']}: quant {sch} cos vs absorbed = {cos:.6f} (>= {floor})")
        assert cos >= floor, (sch, cos)


def check_mla_moe(dev) -> None:
    """One absorbed step through 2G on a V2-Lite-shaped stack with a MoE layer,
    against the same step through the plain attention."""
    import numpy as np
    import torch

    from nerf_attention_tpu_torch.models import mla
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma

    config = mla.MLAConfig.from_hf_dict({**V2_LITE, "num_hidden_layers": 2})
    print(f"  {config.num_dense_layers} dense + {config.num_moe_layers} MoE layer ({config.n_routed_experts} "
          f"experts, top-{config.num_experts_per_tok}, {config.n_shared_experts} shared, width "
          f"{config.moe_intermediate_size}), bf16, S=4096, position 4096")
    t0 = time.perf_counter()
    params = mla.init_random_mla(config, seed=0, dtype=torch.bfloat16, device=dev)
    print(f"  random weights from seed 0: {time.perf_counter() - t0:.1f}s")
    gen = torch.Generator().manual_seed(4096)
    lat = (torch.randn(2, 4096, config.latent_dim, generator=gen) * 0.5).to(dev, torch.bfloat16)
    before = ma.launches["mla_absorbed_attention"]
    got = mla.mla_decode_step_absorbed(config, params, 7, 4096, lat, attn_impl="cuda")
    want = mla.mla_decode_step_absorbed(config, params, 7, 4096, lat)
    torch.cuda.synchronize()
    assert ma.launches["mla_absorbed_attention"] == before + 2
    h, h_plain = (x[0].float().cpu().numpy() for x in (got, want))
    cos = float(np.dot(h, h_plain) / (np.linalg.norm(h) * np.linalg.norm(h_plain)))
    ent_gap = (got[2] - want[2]).abs().max().item()
    print(f"  h: cos(2G, plain) = {cos:.6f} (>= 0.999), finite = {bool(np.isfinite(h).all())}; "
          f"entropy max abs gap = {ent_gap:.3e}")
    assert np.isfinite(h).all() and cos >= 0.999, cos
    assert torch.equal(got[1][0], want[1][0])  # the first layer's new latent row comes before any attention


def check_ladder(payload: dict) -> None:
    """The attention ladder's JSON: the JAX tool's keys, finite medians, parity."""
    keys = {"backend", "config", "n_heads", "head_dim", "n_queries", "sin_impl", "samples_per_point",
            "parity_fused_vs_twopass", "parity_quant_vs_fused_dequant", "quant_schemes", "ladder"}
    row_keys = {"seq_len", "fused_ms", "twopass_ms", "cache_attn_ms", "speedup_vs_twopass", "fused_over_cache",
                "kv_bytes_fp32", "param_bytes_fp32", "compression", "quant_resident", "kv_cache_quant_resident"}
    assert keys <= payload.keys(), keys - payload.keys()
    assert [r["seq_len"] for r in payload["ladder"]] == [2048, 8192, 32768]
    assert payload["quant_schemes"] == list(SCHEMES) and payload["n_heads"] == NUM_HEADS
    print("  S      fused ms   twopass ms  cache ms   " + "  ".join(f"2F[{s}]" for s in SCHEMES)
          + "  " + "  ".join(f"2I[{s}]" for s in SCHEMES))
    for r in payload["ladder"]:
        assert r.keys() == row_keys, r.keys() ^ row_keys
        medians = [r[leg]["median"] for leg in ("fused_ms", "twopass_ms", "cache_attn_ms")]
        medians += [r["quant_resident"][s]["ms"]["median"] for s in SCHEMES]
        medians += [r["kv_cache_quant_resident"][s]["ms"]["median"] for s in SCHEMES]
        assert all(math.isfinite(x) and x > 0 for x in medians), medians
        print(f"  {r['seq_len']:<6} " + "  ".join(f"{x:.5f}" for x in medians))
        print(f"         resident bytes: fp32 params {r['param_bytes_fp32']}, fp32 cache {r['kv_bytes_fp32']}, "
              + ", ".join(f"{s} params {r['quant_resident'][s]['param_bytes_resident']}" for s in SCHEMES) + ", "
              + ", ".join(f"{s} cache {r['kv_cache_quant_resident'][s]['cache_bytes_resident']}" for s in SCHEMES))
    parity = payload["parity_fused_vs_twopass"]
    print(f"  parity fused vs twopass at S={parity['seq_len']}: max_abs_err={parity['max_abs_err']:.3e} "
          f"(atol {ATTN_TOL['atol']})")
    assert parity["max_abs_err"] <= ATTN_TOL["atol"], parity
    for sch, entry in payload["parity_quant_vs_fused_dequant"].items():
        print(f"  parity 2F[{sch}] vs 2D on the dequantized weights: max_abs_err={entry['max_abs_err']:.3e} (must be 0)")
        assert entry["max_abs_err"] == 0.0, entry


def check_decode_quant_kernel(dev, median_ms, stack_for) -> dict:
    """Kernel 2E against its plain version and against 2C on the host-dequantized
    weights (max abs diff 0); its report entry at the plan path's shape."""
    import torch

    from nerf_attention_tpu_torch.models.siren import SirenStack
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    small = CONFIGS_BY_NAME["small"]
    nets = stack_for(small, PLAN_NETS, seed=21)
    cases = [(sch, PLAN_SEQ_LEN, "fast", None) for sch in ("int8_g32", "int4_g128")]
    cases += [(sch, 300, "fast", 32.0) for sch in DECODE_QUANT_SCHEMES] + [("int6_g64", 300, "exact", 32.0)]
    err = 0.0
    for sch, seq_len, sin_impl, fm in cases:
        kw = dict(sin_impl=sin_impl, fm_mult=fm)
        tag = f"2E[{sch}] small N={PLAN_NETS} S={seq_len} {sin_impl} fm={fm}"
        packed = sq.pack_resident_params(nets.params(), sch)
        got = sq.siren_decode_batch_quant(None, sch, small.omega_0, seq_len, packed=packed, **kw)
        want = sq.siren_decode_batch_quant_plain(packed, small.omega_0, seq_len, **kw)
        torch.cuda.synchronize()
        err = max(err, check_close(tag, got, want, **DECODE_TOL))
        dequant = SirenStack.from_params(sq.unpack_resident_params(*packed))
        diff = (got - siren_cuda.siren_decode_batch(dequant, small.omega_0, seq_len, **kw)).abs().max().item()
        print(f"  {tag} vs 2C on the host-dequantized weights: max_abs_diff={diff:.3e} (must be 0)")
        assert diff == 0.0, diff

    # Time at the plan path's shape: the recon leg of int4_g128 with every unit served.
    sch = "int4_g128"
    packed = sq.pack_resident_params(nets.params(), sch)
    macs, _ = siren_macs(nets.dims)
    shape = f"small, N={PLAN_NETS}, S={PLAN_SEQ_LEN}, D={HEAD_DIM}, fast sine, {sch} weights"
    report = dict(
        max_abs_err=err, shape=shape, library_ms=None,
        ms=median_ms(lambda: sq.siren_decode_batch_quant(None, sch, small.omega_0, PLAN_SEQ_LEN, packed=packed,
                                                         sin_impl="fast"), 50),
        plain_ms=median_ms(lambda: sq.siren_decode_batch_quant_plain(packed, small.omega_0, PLAN_SEQ_LEN,
                                                                     sin_impl="fast"), 20),
        **bound(2 * macs * PLAN_SEQ_LEN * PLAN_NETS,
                sq.resident_param_bytes(packed[0]) + PLAN_NETS * PLAN_SEQ_LEN * HEAD_DIM * 4),
    )
    print(f"  siren_decode_batch_quant ({shape}): kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, "
          f"bound {report['bound_ms']:.4f} ms ({report['bound_by']}), library None")
    return report


def check_plan(payload: dict) -> None:
    """The plan-rollout JSON: the JAX tool's keys, finite costs and rates, plans
    that grow with the budget, measured/predicted within 0.1-10, int4 payloads
    below int8 ones for the same units."""
    import torch

    from nerf_attention_tpu_torch.models.siren import init_siren
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    assert payload["reduced"] == PLAN_CUTS and payload["backend"] == "cuda", (payload["reduced"], payload["backend"])
    (seed,) = payload["seeds"]
    keys = {"seed", "solo_costs", "stored_bytes_per_unit", "entropy_nats", "fit_cos_k_mean", "fit_cos_v_mean",
            "base_tokens_per_s", "base_rollout_s_stats", "budgets", "full_swap_mean_cost",
            "full_swap_final_step_cosine", "recon_legs", "hybrid_legs", "wall_s"}
    assert seed.keys() == keys, seed.keys() ^ keys
    n_units = len(seed["entropy_nats"])
    assert n_units == LLAMA_31_8B["num_hidden_layers"] * LLAMA_31_8B["num_key_value_heads"], n_units
    costs = [c for sch in payload["schemes"] for c in seed["solo_costs"][sch]]
    assert all(math.isfinite(c) and c > 0 for c in costs), costs
    print(f"  {n_units} units; fit CosSim K {seed['fit_cos_k_mean']:.4f} / V {seed['fit_cos_v_mean']:.4f}; entropy "
          f"{min(seed['entropy_nats']):.2f}-{max(seed['entropy_nats']):.2f} nats; solo cost medians "
          + ", ".join(f"{sch} {np.median(seed['solo_costs'][sch]):.3e}" for sch in payload["schemes"]))
    stats = seed["base_rollout_s_stats"]
    print(f"  base rollout: {seed['base_tokens_per_s']:.1f} tokens/s ({payload['rollout_tokens']} tokens, "
          f"{stats['median'] * 1e3:.2f} ms, IQR {stats['iqr'] * 1e3:.2f} ms)")
    served = []
    for r in seed["budgets"]:
        s = r["rollout_s_stats"]
        print(f"  budget {r['cost_target']:g}: served {r['n_served']}/{n_units} {r['schemes_served']}, predicted "
              f"{r['predicted_cost_at_cut']:.3e}, measured {r['rollout_mean_cost']:.3e} "
              f"(x{r['measured_over_predicted']:.3f}), final-step cosine {r['rollout_final_step_cosine']:.6f}, "
              f"{r['tokens_per_s']:.1f} tokens/s (IQR {s['iqr'] * 1e3:.2f} ms), net bytes saved {r['net_bytes_saved']}")
        assert math.isfinite(r["tokens_per_s"]) and r["tokens_per_s"] > 0, r["tokens_per_s"]
        assert math.isfinite(r["rollout_mean_cost"]), r["rollout_mean_cost"]
        if r["n_served"]:
            assert 0.1 <= r["measured_over_predicted"] <= 10.0, r["measured_over_predicted"]
        served.append(r["n_served"])
    assert served == sorted(served), served
    assert math.isfinite(seed["base_tokens_per_s"]) and seed["base_tokens_per_s"] > 0
    print(f"  full swap (every unit from the master fit): mean cost {seed['full_swap_mean_cost']:.3e}, final-step "
          f"cosine {seed['full_swap_final_step_cosine']:.6f}")
    assert seed["recon_legs"], "the top budget served no quantized unit: no recon leg ran kernel 2E"
    small = CONFIGS_BY_NAME["small"]
    for leg in seed["recon_legs"]:
        n = 2 * leg["n_units_served"]
        # Resident bytes depend on the shapes alone: the same units packed both ways.
        nets = init_siren(small, HEAD_DIM, generator=torch.Generator(), n=n)
        by_scheme = {sch: sq.resident_param_bytes(sq.pack_resident_params(nets, sch)[0])
                     for sch in ("int8_g32", "int4_g128")}
        print(f"  recon {leg['scheme']}: {leg['n_units_served']} units ({n} nets) in {leg['recon_ms']:.4f} ms, "
              f"resident {leg['resident_bytes']} B vs raw {leg['raw_bytes_replaced']} B; the same nets as int8_g32 "
              f"{by_scheme['int8_g32']} B, as int4_g128 {by_scheme['int4_g128']} B; "
              f"{leg['tokens_per_s_with_per_rollout_recon']:.1f} tokens/s with a reconstruction per rollout")
        assert leg["resident_bytes"] == by_scheme[leg["scheme"]], (leg["resident_bytes"], by_scheme)
        assert by_scheme["int4_g128"] < by_scheme["int8_g32"], by_scheme
        assert math.isfinite(leg["tokens_per_s_with_per_rollout_recon"]) and leg["recon_ms"] > 0
    print(f"  wall {seed['wall_s']:.1f}s")


def main() -> int:
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this run needs a GPU", file=sys.stderr)
        return 1
    with phase("1 device"):
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        smi = nvidia_smi_line()
        print(f"  nvidia-smi: {smi}")
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from nerf_attention_tpu_torch.evaluate import profile_latency
    from nerf_attention_tpu_torch.fit import fit_kv_cache, kv_cosine_means
    from nerf_attention_tpu_torch.io import kvstore
    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren, layer_dims
    from nerf_attention_tpu_torch.ops import (
        _build,
        kv_quant_cuda,
        mla_absorbed_cuda,
        mla_quant_cuda,
        siren_attention_cuda,
        siren_cuda,
        siren_quant_cuda,
        siren_train_cuda,
    )
    from nerf_attention_tpu_torch.tools import measure_attention_decode, mla_decode_bench, plan_rollout_study
    from nerf_attention_tpu_torch.parallel.sweep import fit_batch, normalize_targets
    from nerf_attention_tpu_torch.synthetic import generate_synthetic_kv
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME, CONFIGS_FULL
    from nerf_attention_tpu_torch.utils.device import pin_fp32_matmul
    from nerf_attention_tpu_torch.utils.timing import kernel_ms_per_call, per_launch_ms

    pin_fp32_matmul()
    dev = torch.device("cuda")

    # ---- 2. build ----
    with phase("2 build"):
        def build(name):
            t0 = time.perf_counter()
            _build.load_library(name)
            return time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
            took = dict(zip(LIBRARIES, pool.map(build, LIBRARIES)))
        for name in LIBRARIES:
            print(f"  {name}: built and loaded in {took[name]:.1f}s")
            for line in _build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line or "stack frame" in line:
                    print(f"    ptxas: {line.strip()}")

    def stack_for(config, n, seed):
        gen = torch.Generator().manual_seed(seed)
        cpu = SirenStack.from_params(init_siren(config, HEAD_DIM, generator=gen, n=n))
        return SirenStack(cpu.flat.to(dev), cpu.dims)

    def median_ms(fn, reps):
        return float(np.median(per_launch_ms(fn, reps, 3, dev)))

    report = {}

    # ---- 3. kernels against their plain versions ----
    with phase("3 kernels"):
        medium = CONFIGS_BY_NAME["medium"]
        decode_err = {"siren_decode": 0.0, "siren_decode_batch": 0.0}
        for n, wrapper in ((1, "siren_decode"), (N_FITS, "siren_decode_batch")):
            stack = stack_for(medium, n, seed=n)
            fn = getattr(siren_cuda, wrapper)
            for sin_impl, fm in (("exact", None), ("fast", None), ("exact", FM_MULT)):
                kw = dict(sin_impl=sin_impl, fm_mult=fm)
                got = fn(stack, medium.omega_0, SEQ_LEN, **kw)
                want = siren_cuda.siren_decode_plain(stack, medium.omega_0, SEQ_LEN, **kw)
                if n == 1:
                    want = want[0]
                torch.cuda.synchronize()
                err = check_close(f"{wrapper} N={n} medium {sin_impl} fm={fm}", got, want, **DECODE_TOL)
                decode_err[wrapper] = max(decode_err[wrapper], err)
            run = lambda: fn(stack, medium.omega_0, SEQ_LEN)
            plain = lambda: siren_cuda.siren_decode_plain(stack, medium.omega_0, SEQ_LEN)
            macs, pbytes = siren_macs(stack.dims)
            report[wrapper] = dict(
                max_abs_err=decode_err[wrapper], ms=median_ms(run, 50), plain_ms=median_ms(plain, 50),
                shape=f"medium, N={n}, S={SEQ_LEN}, D={HEAD_DIM}, exact sine", library_ms=None,
                **bound(2 * macs * SEQ_LEN * n, n * (pbytes + SEQ_LEN * HEAD_DIM * 4)),
            )
            print(f"  {wrapper} N={n}: kernel {report[wrapper]['ms']:.4f} ms, "
                  f"plain {report[wrapper]['plain_ms']:.4f} ms")
        # 2C as the ladder's two-pass leg runs it: 8 medium key nets, fast sine, every S of the ladder.
        k_stack = attention_inputs(NUM_HEADS, 1, dev, seed=3)[0]
        for seq_len in measure_attention_decode.LADDER:
            got = siren_cuda.siren_decode_batch(k_stack, medium.omega_0, seq_len, sin_impl="fast")
            want = siren_cuda.siren_decode_plain(k_stack, medium.omega_0, seq_len, sin_impl="fast")
            torch.cuda.synchronize()
            err = check_close(f"siren_decode_batch N={NUM_HEADS} S={seq_len} medium fast (two-pass leg)",
                              got, want, **DECODE_TOL)
            report["siren_decode_batch"]["max_abs_err"] = max(report["siren_decode_batch"]["max_abs_err"], err)
        del k_stack, got, want

        def targets_for(n, seq_len, seed):
            gen = torch.Generator().manual_seed(seed)
            return normalize_targets(torch.randn(n, seq_len, HEAD_DIM, generator=gen).to(dev))[0].contiguous()

        def check_train(stack, targets_norm, tag, tol, **kw):
            loss, grads = siren_train_cuda.siren_train_grads(stack, targets_norm, **kw)
            want_loss, want_grads = siren_train_cuda.siren_train_grads_plain(stack, targets_norm, **kw)
            torch.cuda.synchronize()
            err = check_close(f"{tag} loss", loss, want_loss, **tol["loss"])
            for i, ((gw, gb), (ww, wb)) in enumerate(zip(grads.params(), want_grads.params())):
                err = max(err, check_close(f"{tag} dW{i}", gw, ww, **tol["grads"]))
                err = max(err, check_close(f"{tag} db{i}", gb, wb, **tol["grads"]))
            return err

        targets_norm = targets_for(N_FITS, SEQ_LEN, seed=7)
        train_err = 0.0
        train_ms = {}
        for config in CONFIGS_FULL:
            stack = stack_for(config, N_FITS, seed=config.hidden_features)
            for sin_impl in ("exact", "fast"):
                train_err = max(train_err, check_train(
                    stack, targets_norm, f"siren_train_grads N={N_FITS} {config.name} {sin_impl}", TRAIN_TOL[sin_impl],
                    omega=config.omega_0, sin_impl=sin_impl))
            kw = dict(omega=config.omega_0, sin_impl="fast")
            train_ms[config.name] = (
                median_ms(lambda: siren_train_cuda.siren_train_grads(stack, targets_norm, **kw), 10),
                median_ms(lambda: siren_train_cuda.siren_train_grads_plain(stack, targets_norm, **kw), 10),
            )
            print(f"  siren_train_grads N={N_FITS} {config.name} fast: kernel {train_ms[config.name][0]:.4f} ms, "
                  f"plain {train_ms[config.name][1]:.4f} ms per step")
        # The plan path's shape, and rows that are not a multiple of the kernel's 64-row tile with FM.
        small = CONFIGS_BY_NAME["small"]
        plan_stack, plan_targets = stack_for(small, PLAN_NETS, seed=22), targets_for(PLAN_NETS, PLAN_SEQ_LEN, seed=8)
        for sin_impl in ("fast", "exact"):
            train_err = max(train_err, check_train(
                plan_stack, plan_targets, f"siren_train_grads small N={PLAN_NETS} S={PLAN_SEQ_LEN} {sin_impl} (plan)",
                TRAIN_TOL[sin_impl], omega=small.omega_0, sin_impl=sin_impl))
        ragged = targets_for(N_FITS, 300, seed=9)
        for config in (medium, CONFIGS_BY_NAME["tiny"]):
            for sin_impl in ("exact", "fast"):
                train_err = max(train_err, check_train(
                    stack_for(config, N_FITS, seed=23), ragged,
                    f"siren_train_grads N={N_FITS} {config.name} S=300 {sin_impl} fm={FM_MULT}", TRAIN_TOL["fm"],
                    omega=config.omega_0, sin_impl=sin_impl, fm_mult=FM_MULT))
        # Forward, and the backward's two products per layer: 6 flops per multiply-add, on the tensor cores
        # in TF32 (3xTF32 counted once; the three passes' floor is printed beside it).
        macs, pbytes = siren_macs(layer_dims(medium, HEAD_DIM))
        train_flops = 6 * macs * SEQ_LEN * N_FITS
        report["siren_train_grads"] = dict(
            max_abs_err=train_err, ms=train_ms["medium"][0], plain_ms=train_ms["medium"][1],
            shape=f"medium, N={N_FITS}, S={SEQ_LEN}, D={HEAD_DIM}, fast sine, loss + all grads", library_ms=None,
            **bound(train_flops, N_FITS * (SEQ_LEN * HEAD_DIM * 4 + 2 * pbytes + 4), PEAK_TF32_FLOPS),
        )
        medium_stack = stack_for(medium, N_FITS, seed=medium.hidden_features)
        split = kernel_ms_per_call(lambda: siren_train_cuda.siren_train_grads(
            medium_stack, targets_norm, omega=medium.omega_0, sin_impl="fast"), 10, dev)
        print(f"  siren_train_grads medium N={N_FITS} fast, device ms per step by kernel (torch.profiler, 10 steps):")
        for name, entry in split.items():
            short = name.replace("(anonymous namespace)::", "").split("(")[0]
            print(f"    {entry['ms']:.4f} ms x{entry['calls']:g}  {short}")
        print(f"  siren_train_grads medium N={N_FITS}: {train_flops / 1e9:.1f} GFLOP, kernel "
              f"{train_ms['medium'][0]:.4f} ms ({train_flops / train_ms['medium'][0] / 1e9:.1f} TFLOP/s counted once), "
              f"bound {report['siren_train_grads']['bound_ms']:.4f} ms ({report['siren_train_grads']['bound_by']}, "
              f"TF32 peak), three-pass floor {3 * train_flops / PEAK_TF32_FLOPS * 1e3:.4f} ms, the fp32 SIMT "
              f"kernel's {TRAIN_SIMT_MS} ms (its earlier version, same card type)")

        # A short training run on the GPU against the same run on the CPU.
        small_t = np.random.default_rng(3).standard_normal((4, 256, 16)).astype(np.float32)
        runs = {d: fit_batch(small_t, medium, epochs=30, seed=5, device=d) for d in ("cuda", "cpu")}
        check_close("fit_batch 30 epochs cuda vs cpu: losses",
                    torch.from_numpy(runs["cuda"].losses), torch.from_numpy(runs["cpu"].losses),
                    rtol=1e-3, atol=1e-5)
        cos_gap = float(np.max(np.abs(runs["cuda"].cosine_mean - runs["cpu"].cosine_mean)))
        print(f"  fit_batch cuda vs cpu: max |cosine_mean gap| = {cos_gap:.2e} (limit 2e-3)")
        assert cos_gap <= 2e-3, cos_gap

        report.update(check_attention_kernels(dev, median_ms))
        report.update(check_mla_kernels(dev, median_ms))
        report["siren_decode_batch_quant"] = check_decode_quant_kernel(dev, median_ms, stack_for)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        for counts in (siren_cuda.launches, siren_train_cuda.launches):
            for key in counts:
                counts[key] = 0

        # ---- 4. the main path: synthetic cache -> 280-fit sweep ----
        with phase("4 sweep"):
            t0 = time.perf_counter()
            generate_synthetic_kv(
                seq_len=SEQ_LEN, num_layers=NUM_LAYERS, num_kv_heads=NUM_HEADS, head_dim=HEAD_DIM,
                output_dir=tmp / "kv", verbose=False, layer_indices=SWEEP_LAYERS,
            )
            print(f"  synthetic cache: {time.perf_counter() - t0:.1f}s")
            print(f"  epochs={SWEEP_EPOCHS} (reduced from the study's 2000 to keep this run short)")
            t0 = time.perf_counter()
            results = fit_kv_cache(tmp / "kv", tmp / "fits", epochs=SWEEP_EPOCHS, device=dev, verbose=False)
            wall = time.perf_counter() - t0
            meta = json.loads((tmp / "fits" / "sweep_meta.json").read_text())
            for config in CONFIGS_FULL:
                recs = [r for r in results if r["config_name"] == config.name]
                print(f"  group {config.name:<7} {sum(r['train_time_seconds'] for r in recs):7.2f}s "
                      f"({len(recs)} fits, impl {meta['impl'][config.name]})")
            k_cos, v_cos = kv_cosine_means(results)
            print(f"  {len(results)} fits in {wall:.2f}s = {len(results) / wall:.3f} fits/s; "
                  f"mean CosSim K {k_cos:.4f} / V {v_cos:.4f}")
            assert len(results) == 280, len(results)
            assert set(meta["impl"].values()) == {"cuda"}, meta["impl"]
            for r in results:
                for key in ("final_mse", "final_cosine_mean", "final_cosine_min", "final_cosine_std"):
                    assert math.isfinite(r[key]), (r["name"], key, r[key])
            assert len(list((tmp / "fits").glob("*_medium_model.npz"))) == N_FITS

        # ---- 5. the study's question ----
        with phase("5 latency"):
            print("  one sample = 200 back-to-back decode launches (or 20 full-pool reads) timed "
                  "with CUDA events, per launch (per slice); median of 5 samples")
            rows = profile_latency(tmp / "fits", tmp / "latency", max_models=8, device=dev)
            assert len(rows) == 8 and all(math.isfinite(r["siren_time_ms"]) for r in rows)

        # ---- 6. launches on the sweep path ----
        with phase("6 launches"):
            launches = {**siren_cuda.launches, **siren_train_cuda.launches}
            print(f"  {launches}")
            for name, count in launches.items():
                assert count > 0, f"{name} was not launched on the sweep path"

        # ---- 7. the attention-decode path: the ladder at full width ----
        attention_counts = (siren_attention_cuda.launches, siren_quant_cuda.launches, kv_quant_cuda.launches)
        for counts in attention_counts:
            for key in counts:
                counts[key] = 0
        siren_cuda.launches["siren_decode_batch"] = 0  # 2C runs the two-pass leg
        with phase("7 ladder"):
            print(f"  {NUM_HEADS} heads, D={HEAD_DIM}, T=1, medium, fast sine, schemes {','.join(SCHEMES)}; one "
                  "sample = back-to-back launches between CUDA events, per launch; median of 5 samples")
            payload = measure_attention_decode.main(["--out", str(tmp / "attention")])
        ladder_launches = {k: counts[k] for counts in attention_counts for k in counts
                           if k != "siren_decode_batch_quant"}  # 2E is the plan path's (phase 13)
        ladder_launches["siren_decode_batch"] = siren_cuda.launches["siren_decode_batch"]

        # ---- 8. launches on the attention path ----
        with phase("8 launches"):
            print(f"  {ladder_launches}")
            for name, count in ladder_launches.items():
                assert count > 0, f"{name} was not launched on the attention path"
            check_ladder(payload)
        for name, count in ladder_launches.items():  # the kernels line counts both paths' launches
            launches[name] = launches.get(name, 0) + count

        # ---- 9. determinism ----
        with phase("9 determinism"):
            layers = [kvstore.load_layer(tmp / "kv", layer) for layer in SWEEP_LAYERS]
            medium_targets = np.stack([kv[h] for kv_pair in layers for h in range(4) for kv in kv_pair])
            a, b = (fit_batch(medium_targets, medium, epochs=50, seed=20_000, device=dev) for _ in range(2))
            same = np.array_equal(a.losses, b.losses) and all(
                np.array_equal(x, y) for pa, pb in zip(a.params, b.params) for x, y in zip(pa, pb)
            )
            print(f"  medium, {N_FITS} fits x 50 epochs, twice: losses and params bit-identical = {same}")
            assert same
            k, v, stats, q = attention_inputs(NUM_HEADS, 16, dev, seed=11)
            ck, cv, cq = random_cache(NUM_HEADS, 32768, 16, dev, seed=12)
            packed = tuple(siren_quant_cuda.pack_resident_params(p.params(), SCHEMES[1]) for p in (k, v))
            pk, pv = (kv_quant_cuda.pack_kv_unit_stack(c, SCHEMES[1]) for c in (ck, cv))
            mla_q, mlat, mnew = mla_inputs(32768, dev, seed=13)
            mla_packed = mla_quant_cuda.pack_resident_latent(mlat, "int6_g64")
            e_packed = siren_quant_cuda.pack_resident_params(
                stack_for(CONFIGS_BY_NAME["small"], PLAN_NETS, seed=14).params(), "int4_g128")
            mla_args = dict(kv_lora_rank=MLA_R, scale=MLA_SCALE)
            large = CONFIGS_BY_NAME["large"]
            large_stack = stack_for(large, N_FITS, seed=15)
            large_targets = torch.from_numpy(medium_targets).to(dev, torch.float32)
            large_targets = normalize_targets(large_targets)[0].contiguous()

            def train_large():
                loss, grads = siren_train_cuda.siren_train_grads(large_stack, large_targets, omega=large.omega_0,
                                                                 sin_impl="fast")
                return loss, grads.flat

            twice = {
                "2A": train_large,
                "2D": lambda: siren_attention_cuda.siren_attention_decode_fused(k, v, *stats, q, 30.0, 8192),
                "2F": lambda: siren_quant_cuda.siren_attention_decode_quant(
                    None, None, *stats, q, SCHEMES[1], 30.0, 8192, packed=packed, return_stats=True),
                "2I": lambda: kv_quant_cuda.kv_cache_attention_quant(cq, pk, pv, 32768 - 5, scale=HEAD_DIM ** -0.5,
                                                                      return_stats=True),
                "2G": lambda: mla_absorbed_cuda.mla_absorbed_attention(mla_q, mlat.to(torch.bfloat16), mnew, 32768 - 5,
                                                                       **mla_args),
                "2H": lambda: mla_quant_cuda.mla_absorbed_attention_quant(mla_q, mla_packed, mnew, 32768 - 5,
                                                                          **mla_args),
                "2E": lambda: siren_quant_cuda.siren_decode_batch_quant(
                    None, "int4_g128", 30.0, PLAN_SEQ_LEN, packed=e_packed, sin_impl="fast"),
            }
            for name, run in twice.items():
                a, b = run(), run()
                same = all(torch.equal(x, y) for x, y in zip(a if isinstance(a, tuple) else (a,),
                                                             b if isinstance(b, tuple) else (b,)))
                what = {"2A": f"large, N={N_FITS}, S={SEQ_LEN}, the sweep's targets, loss and grads",
                        "2G": "H=16, S_buf=32768", "2H": "H=16, S_buf=32768",
                        "2E": f"{PLAN_NETS} small nets, S={PLAN_SEQ_LEN}, int4_g128"}.get(name, "T=16")
                print(f"  {name} twice on the same inputs ({what}): bit-identical = {same}")
                assert same

        # ---- 10. the MLA decode path: the ladder at DeepSeek-V2-Lite's widths ----
        mla_counts = (mla_absorbed_cuda.launches, mla_quant_cuda.launches)
        for counts in mla_counts:
            for key in counts:
                counts[key] = 0
        with phase("10 mla"):
            print(f"  DeepSeek-V2-Lite attention and dense FFN: H={MLA_H}, kv_lora_rank {MLA_R}, rope {MLA_ROPE}, "
                  "nope 128, v 128, hidden 2048, no q LoRA, intermediate 10944, bf16, random weights from seed 0, "
                  f"rope scaling {V2_LITE['rope_scaling']}; cut: 4 dense layers (of 27: 1 dense + 26 MoE), "
                  "vocabulary 4096 (of 102400; the step reads one embedding row and has no LM head). One sample = "
                  "20 back-to-back steps between CUDA events, per step; median of 5 samples; device = profiled "
                  "kernel time per step")
            mla_payload = mla_decode_bench.main([
                "--out", str(tmp / "mla"), "--intermediate_size", "10944", "--num_layers", "4",
                "--dtype", "bfloat16", "--ladder", ",".join(map(str, MLA_LADDER)), "--reps", "20",
                "--quant_schemes", ",".join(MLA_LADDER_SCHEMES), "--rope_scaling", json.dumps(V2_LITE["rope_scaling"])])
        mla_launches = {k: v for counts in mla_counts for k, v in counts.items()}

        # ---- 11. launches on the MLA path, and its JSON ----
        with phase("11 launches"):
            print(f"  {mla_launches}")
            for name, count in mla_launches.items():
                assert count > 0, f"{name} was not launched on the MLA path"
            check_mla_ladder(mla_payload)
        launches.update(mla_launches)

        # ---- 12. the MoE layer on the card ----
        with phase("12 moe"):
            check_mla_moe(dev)

        # ---- 13. the serve-plan rollout path at Llama-3.1-8B's widths ----
        plan_kernels = ((siren_train_cuda.launches, "siren_train_grads"), (siren_cuda.launches, "siren_decode_batch"),
                        (siren_quant_cuda.launches, "siren_decode_batch_quant"))
        for counts, key in plan_kernels:
            counts[key] = 0
        with phase("13 plan"):
            print(f"  Llama-3.1-8B widths: hidden 4096, 32 query / 8 KV heads, head_dim 128, SiLU FFN 14336, "
                  "rope_theta 500000 with llama3 scaling (factor 8, low 1, high 4, original 8192), rms eps 1e-5; "
                  "fp32, TF32 off; random weights from seed 0 with the tool's head gains (1-64)")
            print(f"  cuts: {'; '.join(PLAN_CUTS)}")
            print("  the tool's defaults otherwise: S=512, 64 rollout tokens, budgets 0.003/0.01/0.03, schemes "
                  "master/int8_g32/int4_g128, `small` nets, 2000 epochs, 8 queries; one timing sample = 5 "
                  "back-to-back rollouts (or reconstructions) between CUDA events, median of 3 samples")
            plan_payload = plan_rollout_study.main([
                "--out", str(tmp / "plan_rollout.json"), "--seeds", "0", "--llama_config", json.dumps(LLAMA_31_8B),
                "--reduced", *PLAN_CUTS])
        plan_launches = {key: counts[key] for counts, key in plan_kernels}

        # ---- 14. launches on the plan path, and its JSON ----
        with phase("14 launches"):
            print(f"  {plan_launches}")
            for name, count in plan_launches.items():
                assert count > 0, f"{name} was not launched on the plan path"
            check_plan(plan_payload)
        for name, count in plan_launches.items():  # the kernels line counts every path's launches
            launches[name] = launches.get(name, 0) + count

    sources = {
        "siren_train_grads": ("nerf_attention_tpu_torch/csrc/siren_train.cu",
                              "nerf_attention_tpu/ops/siren_train_pallas.py:252"),
        "siren_decode": ("nerf_attention_tpu_torch/csrc/siren_decode.cu",
                         "nerf_attention_tpu/ops/siren_pallas.py:120"),
        "siren_decode_batch": ("nerf_attention_tpu_torch/csrc/siren_decode.cu",
                               "nerf_attention_tpu/ops/siren_pallas.py:279"),
        "siren_attention_decode_fused": ("nerf_attention_tpu_torch/csrc/siren_attention.cu",
                                         "nerf_attention_tpu/ops/siren_attention_pallas.py:151"),
        "siren_attention_decode_quant": ("nerf_attention_tpu_torch/csrc/siren_attention.cu",
                                         "nerf_attention_tpu/ops/siren_quant_pallas.py:512"),
        "kv_cache_attention_quant": ("nerf_attention_tpu_torch/csrc/kv_quant_attention.cu",
                                     "nerf_attention_tpu/ops/kv_quant_pallas.py:172"),
        "mla_absorbed_attention": ("nerf_attention_tpu_torch/csrc/mla_absorbed_attention.cu",
                                   "nerf_attention_tpu/ops/mla_absorbed_pallas.py:138"),
        "mla_absorbed_attention_quant": ("nerf_attention_tpu_torch/csrc/mla_absorbed_attention.cu",
                                         "nerf_attention_tpu/ops/mla_quant_pallas.py:249"),
        "siren_decode_batch_quant": ("nerf_attention_tpu_torch/csrc/siren_decode_quant.cu",
                                     "nerf_attention_tpu/ops/siren_quant_pallas.py:285"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         **{k: report[name][k] for k in keys}}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
