#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_attention_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phase by phase, each printing its seconds; any failure exits non-zero:

  1. device   the card, its power limit, torch and CUDA versions (no GPU: exit 1)
  2. build    every CUDA kernel from nerf_attention_tpu_torch/csrc with nvcc,
              one nvcc per source (two for the four slowest, one a sine:
              ops/_build.py's PARTS), and the host generator csrc/synthkv.cpp
              with g++, all started together; this phase waits for the
              study's libraries (2A, 2B/2C/2E, 2C's bf16 mode, the
              generator), phases 4 and 5 run next while the others compile,
              and "2 build, the rest" waits for those before phase 3
  3. kernels  each kernel against its plain PyTorch version at the main paths'
              shapes (sweep and decode: S=2048, D=128; 2A at all 7 configs,
              N=40, exact and fast sine, at the plan path's 128 `small`
              nets with S=512, and at S=300 with FM x64; attention: 8 heads,
              medium nets, S=2048 and 32768, T=1, and T=16 causal, exact sine,
              FM x64, ragged S=300; 2C also at 8 heads, fast sine, each S of
              the ladder; nets the kernels take only with zero units added:
              hidden 96, 72 and 32, no hidden layer, 16 layers, D=3 and 18,
              through 2A, 2C and 2D; wide nets, hidden 2048 and 3632, through
              2C, 2D, 2E and 2F), with the tolerances of the CPU tests,
              and its time beside the plain version's; one short training
              run on the GPU against the same run on the CPU; the 16-layer
              FM x64 net's errors against float64 (kernels and plain
              versions); each row tile of 2C and 2D timed alone beside the
              tile the wrappers pick; at the study's shapes: 2A at N=6, S
              512-8192 and N=64, S=2048; 2B at S 512-8192 and in bf16; 2C at
              N=512 in fp32 exact, fp32 fast and bf16, in bf16 at N=40 and
              through the wide tile; 2A and 2C with coordinates pinned to a
              longer cache (medium, N=4, S 2304 and 4096, total_len 4096)
              against their plain versions, and total_len = S equal to the
              default coordinates bit for bit; 2E on the resident payload of
              4 checkpoints' master weights against 2C on the same
              checkpoints reloaded from compress's int4_g128 and int8_g32
              files (max abs diff 0)
  4. study    python -m nerf_attention_tpu_torch.study, every stage on the
              card: the synthetic cache (32 layers, 8 heads, S=2048, D=128)
              and its analysis, the 280-fit sweep of all 7 configs, the
              figures' data and profile_latency (8 medium checkpoints: the
              fused decode against a measured bf16 read of the slice), the
              scaling ladder 512-8192, four prompts, the SVD grid, the
              32-layer profile and the 512-net aggregate decode (2C fp32,
              bf16 and fast sine against a measured stream read of the
              whole cache), the quantize experiment at its defaults (40
              checkpoints, 7 schemes, 300 QAT epochs at N=40 through 2A,
              reconstructions through 2C) and, with --compress
              int4_g128_qat, compress (QAT through 2A, 40 packed files
              verified through 2C); with --attention, the attention-output
              end-metric (layers 0/8/17/31, 2 heads' K and V fitted by 2A,
              rebuilt by 2C, 256 causal queries, gains 1/8/32/64); with
              --serving, the head-policy study on its hermetic dense Llama
              (8 layers x 4 KV heads, S=512, 64 `small` nets through 2A, the
              master and int8_g32_l0fp32 payloads through 2C, the masked
              decodes) and the greedy and tiered serving plans; at 200
              epochs instead of 2000 to save time; the caches from the host
              generator
  5. study checks  every JSON artifact of the JAX study's path with its keys
              and finite numbers; 280 records and 40 medium checkpoints; 8
              latency rows; the card's analysis and SVD records against the
              port's own on the CPU; 40 x 7 quantization records (fp32 rows
              within 0.02 of the sweep's CosSim, stored_bytes = param_bytes);
              the compressed directory (verified CosSim, each file's packed
              bytes, fit_results.json re-priced); the attention end-metric (4
              probed layers, 2 heads, 256 queries, every output cosine in
              [-1, 1]); the head-policy study (32 units, payloads master and
              int8_g32_l0fp32, every curve's budget-0 cosine within 1e-6 of
              1, the full-budget cosine equal across policies) and both serve
              plans; the figures not drawn; stage seconds, the generator's
              seconds per cache, QAT's ms a step
  6. launches 2A, 2B and 2C (fp32, and 2C in bf16) were launched by phase 4
              (counters zeroed before it), QAT's 2A launches (300 each for the
              experiment and compress) and one 2C launch a reconstruction; the
              attention stage's 2A and 2C launches (4 fits x 200 steps; one
              final evaluation a fit and one 2C a reconstruction) and the
              serving stage's (one fit of 200 steps, its evaluation, one 2C a
              payload), each exactly
  7. ladder   the attention-decode path: the ladder tool over S=2048, 8192,
              32768 at full width (8 heads, D=128, medium), all five legs
              and three quantized schemes
  8. launches every kernel of the attention path (2C, 2D, 2F, 2I) was
              launched by phase 7 (counters zeroed just before it)
  9. determinism  the medium group twice for 50 epochs, and kernels 2A (large,
              N=40), 2C, 2C and 2B in bf16, 2D, 2F, 2I, 2G, 2H and 2E twice on
              the same inputs: bit-identical
 10. mla      the MLA decode path: the MLA ladder tool at DeepSeek-V2-Lite's
              widths (H=16, kv_lora_rank 512, rope 64, hidden 2048, dense FFN
              10944, bf16, YaRN rope scaling), S=1024/32768 (of the tool's
              1024-32768), all legs and schemes int8_g32, int4_g64; cut to 4
              dense layers and a 4096-row vocabulary (the step reads one
              embedding row, no LM head)
 11. launches kernels 2G and 2H were launched by phase 10 (counters zeroed
              just before it); the ladder's JSON: finite medians, the legs'
              output cosines
 12. moe      one absorbed step through 2G on a V2-Lite-shaped 2-layer stack
              (1 dense layer, then 64 routed experts, top-6, 2 shared, width
              1408) against the same step through the plain attention
 13. plan     the serve-plan rollout path: the plan-rollout tool at
              Llama-3.1-8B's widths (hidden 4096, 32 query / 8 KV heads,
              head_dim 128, FFN 14336, llama3 rope), phase 9's weights (drawn
              on the card from seed 0) with the tool's head gains, the tool's defaults (S=512, 64
              tokens, budgets 0.003/0.01/0.03, master/int8_g32/int4_g128,
              `small` nets, 2000 epochs); cut to 4 layers of 32, a 4096-row
              vocabulary of 128256 (a step reads one embedding row, no LM
              head), one seed of three and 2 timing reps of 5; with --hybrid: the top budget's
              served set as a hybrid rollout per scheme (fp32, int8_g32,
              int4_g128), served units attending through 2F
 14. launches kernels 2A, 2C and 2E were launched by phase 13 (counters zeroed
              just before it); its JSON: finite costs and tokens/s, n_served
              rising with the budget, measured/predicted within 0.1-10, int4
              payloads smaller than int8 ones for the same units; three
              hybrid legs with finite tokens/s, parity with their buffer-swap
              twins >= 0.9999, the device-bytes identity, and resident
              payloads int4_g128 < int8_g32 < fp32 for the same served set
 15. hybrid   the hybrid engine (models/llama_hybrid.py) at Llama-3.1-8B's
              widths, 4 layers, random weights from seed 0 drawn on the card,
              fp32 with TF32 off: (a) the hybrid step, `small` nets from seed
              1, every other KV head of every layer served (16 of 32), fp32
              and int4_g128, S 2048 and 32768, against llama_decode_step over
              the reconstruction-swapped buffer (served rows rebuilt on the
              card by 2C / 2E), and on an (S+64)-row buffer with garbage past
              S against the exact one; (b) the quantized-cache step
              (kernel 2I, T = the query group of 4) on random seeded K/V,
              S=32768 int4_g128 and S=2048 int8_g32 / int6_g64 / int4_g128,
              against llama_decode_step over the host-dequantized buffer;
              each with step ms (median of 3 samples of 10 back-to-back
              steps between CUDA events), device ms and launches per step
              and the kernel's share (torch.profiler), and the fp32-cache
              step's beside it
 16. launches kernels 2F and 2I were launched by the hybrid paths: 2F by
              phase 13's hybrid legs and phase 15, 2I by phase 15 (counters
              zeroed just before each)
 17. incremental  python -m nerf_attention_tpu_torch.experiments incremental:
              the synthetic cache (32 layers, 8 heads, D=128) grown 2048 ->
              4096 by 256, layer 8, 2 heads (N=4), medium nets, relative and
              then absolute coordinates (2A and 2C with total_len); cut to
              200 epochs and 100 warm epochs; finite records, 8 growth steps,
              each warm fit's first trajectory point equal to the stale
              CosSim; its seconds and its 2A / 2C launches (counters zeroed
              before each convention)
 18. stored   python -m nerf_attention_tpu_torch.experiments attention_error
              --schemes int8_g32,int4_g128_qat on phase 4's cache: the
              attention end-metric of stored payloads at full width (4
              layers, 2 heads, S=2048, D=128, 256 queries, medium nets, 200
              epochs, 300 QAT epochs through 2A); the JSON's storage blocks,
              and its 2A and 2C launches exactly
 19. card vs cpu  one probed layer of the attention end-metric (layer 8,
              S=2048, medium, 20 epochs) and a tiny head-policy study (S=48,
              2 layers, `tiny`, 10 epochs) on the card and then on the CPU
              from the same initial params and queries: the two JSONs held to
              the stated tolerances, the measured gaps printed
 20. serving at Llama-3.1-8B's attention widths (hidden 4096, 32 query / 8
              KV heads, head_dim 128, FFN 14336; the experiment's plain RoPE):
              the head-policy study with `small` nets at S=512 and its default
              scheme, measure_entropy --random_init at S=2048 (both cut to 1
              layer of 32, vocabulary 512, 200 epochs of 2000), measure_entropy
              --mla_random_init at its defaults, and extract --synthetic at
              S=2048 into a fresh directory (its files equal phase 4's cache
              byte for byte); each run's seconds and peak device memory
 21. families the Llama families and the HF loaders at GPT-OSS-20B's widths
              (hidden 2880, 64 query / 8 KV heads, head_dim 64, 32 experts
              top-4 of width 2880, sinks, biased projections, a 128-row window
              on the first of each pair of layers, YaRN factor 32; cut to 2 of
              24 layers and a 4096-row vocabulary): the tensors drawn on the
              card under their HF names and layouts, written as two bf16
              safetensors shards with their index, read by load_llama_params,
              every leaf equal to its drawn tensor bit for bit; the prefill at
              S=2048 and the decode step at position S against the prefill of
              S + 1 tokens (the bf16 tolerance stated), entropies and sink
              masses, both times beside the bounds of the function (top-4
              experts) and of the all-experts MoE; KV head 0 of both layers
              fitted by 2A (`small`, 200 epochs, D=64), rebuilt by 2C and
              swapped into a decode (its output cosine), with one 2A step at
              the fit's start and one at its end, and the rebuild, held to
              their plain versions; a 2-layer DeepSeek-V2-Lite (dense, then 64
              experts) written and read by load_mla_params, its prefill K / V /
              latent equal to the drawn weights', 2G's absorbed step on it
              against its plain step and each layer's 2G call against the
              plain attention on the same inputs; 2A and 2C held at the
              head-policy shape (64 `small` nets, S=512, D=32); experiments
              head_policy at its hermetic defaults on each stress axis
              (--hp_experts 8, with --hp_moe_style gpt_oss, --hp_sinks,
              --hp_window 128 --hp_nope, --hp_softcap 30; 200 epochs); seconds
              of the writes and reads, prefill and decode ms (CUDA events), the
              phase's peak device memory, under the nvidia-smi line; its 2A, 2C
              and 2G launches exactly, the holds left out of the counts
 22. text     the text-in path at Llama-3.1-8B's widths (8 of 32 layers, the
              vocabulary cut to the fixture tokenizer's 4096, bf16): the
              checkpoint drawn on the card and written as HF-named shards
              beside the committed Llama-3-format tokenizer
              (tests/data/tokenizer_llama3); the port's ids equal to
              AutoTokenizer's committed ones (expected_ids.json); extract
              --backend jax and hf, each cache equal to llama_prefill_kv on
              those ids bit for bit; the study on the checkpoint stage by
              stage (extract with its analysis, the 280-fit sweep, evaluate)
              and the scaling (512-8192) and multi-prompt experiments through
              --backend jax, every 2A / 2B / 2C launch of each stage accounted
              for (epochs of 2A and one 2C a fit, 1 + 5 x 200 of 2B a timed
              decode, one 2B a per-position curve) and one checkpoint read
              where the stage extracts; its JSONs' keys and finite numbers;
              measure_entropy --model; then a 2-layer DeepSeek-V2-Lite with
              the same tokenizer through extract --backend jax (K, V,
              latents.npy, v_head_dim; equal to mla_prefill_kv bit for bit)
              and measure_entropy --model (MLA detected); the seconds of the
              write, each checkpoint read, the tokenizer, the prefill and
              each stage
 23. studies  the shared-basis study at its defaults (the synthetic cache
              at Llama-3.1-8B's KV geometry, layer 16, trunk widths
              64/128/256/512, baselines tiny/small/medium, 100 epochs of
              2000); the MLA latent study at DeepSeek-V2-Lite's attention
              widths (16 heads, kv_lora_rank 512, rope 64, nope 128, v 128,
              hidden 2048, FFN 10944; cut to 4 layers of 27, S=2048, 100
              epochs) and serve_plan --latent_json on its units; fit --quick
              --profile_dir on phase 4's cache, its Chrome trace holding 2A's
              kernels; each part's seconds and exact 2A / 2C launches, every
              fit_batch held at its own shape (hold_fits, outside the counts)
 24. tools    the ported root tools (nerf_attention_tpu_torch/tools), in
              process: measure_decode at its defaults (2B's ladder S
              512-32768 in fp32, bf16 and fast sine, 5 replicates, each leg
              then held to its plain version; the quality delta of two medium
              fits at S=2048; the 512-net aggregate), train_impl_bench (7
              configs, N=40, S=2048, autograd against 2A; 5 and 20 epochs a
              replicate, 1 replicate), the quantized sustain study (layer 8,
              N=4, 2048 -> 2304, int4_g128) and the FM / FINER studies on a
              hard-mode cache (32-layer metadata, 8 heads, S=2048, D=128),
              reprice_study on the committed artifacts, the end-metric,
              rollout-drift and lifecycle studies and measure_rollout at
              Llama-3.1-8B's widths (2 layers of 32, vocabulary 512, weights
              drawn on the card), prefill_ladder at Llama-3.2-3B's (4 layers
              of 28, bf16, S 2048-32768), the sink figure and plot_study;
              epochs 200 of 2000 (fm_spacing_study 50; warm 100 of 1000, QAT
              30 of 300, absorb 50 of 500); each tool's seconds and exact 2A / 2B / 2C launches,
              every fit_batch and trajectory fit held at its own shape
 25. mesh     the multi-device paths over a fit mesh (parallel/mesh.py),
              spawned by this script: one NCCL rank a card, and where there
              is one card also 2 Gloo ranks sharing cuda:0 (NCCL refuses two
              ranks on a card); in each world the 280-fit sweep through
              fit_kv_cache(mesh=) on phase 4's cache at 200 epochs, every
              fit's losses and CosSim and every record held to an unsharded
              run of the same seeds in this process; 2C at N=512 (fp32 exact,
              bf16), 2D at 8 medium heads (S 2048 and 32768, T=1, fast sine,
              fp32 and bf16), 2E at 128 `small` nets (S=512, int4_g128) and
              2F at 8 heads (int4_g128, S=2048, with (m, l)), fp32 and bf16,
              each rank's nets put on its card once as its resident shard
              (shard_stack / shard_packed from the host, that time said);
              each sharded call on them held to the unsharded kernel on the
              same inputs (bit for bit or not, said; within the unsharded
              tolerances) and bit for bit to the same call on the global
              operands on the card, with the three times; the
              sequence-parallel prefill at
              Llama-3.1-8B's widths (2 of 32 layers, vocabulary 4096, bf16,
              S=8192) against the single-device prefill; Megatron tensor
              parallelism (shard_llama_params): at Llama-3.1-8B's widths
              (vocabulary 4096; all 32 layers on NCCL ranks, 2 on the Gloo
              ones) the prefill at S=8192, the decode step at 8192 over each
              rank's heads of a buffer of 8192 + 16 rows and a 16-token
              rollout, and at GPT-OSS-20B's (2 of 24 layers, S=2048, an
              8-token rollout), each against the unsharded call on the same
              weights, bit for bit in a world of one and within the bf16
              bars otherwise, every sum over the ranks the same bits on every
              rank, the times a token beside the unsharded ones; extract
              --backend jax --mesh tp (one NCCL rank) bit for bit against the
              unsharded extraction; each rank's kernel launches and
              collectives asserted, a failing rank failing the phase

Phase 3 also drives the bf16 modes of 2D and 2F (8 medium heads, S 2048 and
32768 at T=1, T=16 causal at 2048, int4_g128) and 2E (128 `small` nets at
S=512, and the T=1 cases' 8 key nets at their S; int4_g128) through their
public entry points, once per shape, and counts their launches: no path of
either package calls these modes, so this is theirs. Outside the counts it
holds each output to its plain version within BF16_ULPS bf16 ulps of the
largest |output|, and to the fp32 mode's output on the same inputs: they
differ, and the fp32 mode sits at least MODE_GAIN times farther (relative
RMS) from the bf16 plain version than the bf16 mode does. 2D's bias tables
and layer 0 row are held rounded: the plain version with either left fp32
sits at least TABLE_GAIN times farther from the bf16 plain version than
2D's kernel does, on the key net's side (the softmax max) and the value
net's (the output at q = 0). 2F and 2E on
packed weights equal themselves over the host-dequantized weights shipped
dense (max abs diff 0); each mode is timed beside its plain version and its
fp32 mode, and beside the layer stack's instance of its arithmetic, whose
output on the timing shape is held to the same plain version. Phase 5 also
checks the study's 40 reference-format *_model.pt beside the 40 .npz, each
equal to its twin.

Phase 3 also holds kernel 2F at the hybrid engine's shape (`small` nets, T=4,
N 1 and 8, S 512, 2048 and 32768, fp32 / int8_g32 / int4_g128 payloads,
the whole window with stats) to its plain version and to 2D on the
host-dequantized weights (max abs diff 0), and phase 9 runs one hybrid
step (S=2048, int4_g128) twice.

Phase 3 also holds kernels 2G and 2H (H=16, r=512, rope 64; S_buf 1024,
32768, 300 and 0; the logit scale with and without YaRN's mscale^2; and 4
and 128 heads at S_buf one row short of, at and one past the kernel's tile)
to their plain versions, and 2H to 2G on the host-dequantized latent (max
abs diff 0); and kernel 2E (128 `small` nets, S=512, D=128, int8_g32 and
int4_g128, fast sine, as the plan path runs it; S=300 with FM x32 in five
schemes) to its plain version, and to 2C on the host-dequantized weights
(max abs diff 0). Each kernel's time at the main path's shapes stands beside its
plain version's, its bound (the larger of its bytes at 3.35 TB/s and its
operations at the peak for their operand type: 67 TFLOP/s fp32, 989 TFLOP/s
bf16 and 495 TFLOP/s TF32 on the tensor cores (2A-2F and 2H, whose products
run in 3xTF32: counted as one pass, the fp32 peak's bound beside it as
fp32_bound_ms); from this run's shapes) and, where one PyTorch
call computes the same function, that call's time (library_ms; the port
never calls it). Every kernel's ms, plain_ms and library_ms are the time
per call of back-to-back calls between CUDA events; 2G and 2H also give
device_ms, their kernels' own time per call (torch.profiler) with the
cache read from device memory (the calls cycle through copies of it larger
than the L2; tools/mla_kernel_times.py), the time to hold against their
bound. Kernel 2I is held to its plain version at 8 heads, D=128, S 2048,
8192, 32768 and 300, T 1, 4, 8 and 16, the three schemes, positions S,
S - 37, 1 and 0; at D 64 and 256; and on a tile-64 pack of S=300, where
positions past S equal position S bit for bit. Its entry adds device_ms and
cold_device_ms at S=32768, T=1, int4_g128 (tools/kv_quant_kernel_times.py)
with the bytes bound and SDPA's device time over the fp32 cache there.

Its `siren_decode_batch (bf16)` entry is 2C's bf16 mode at the aggregate decode's shape (N=512, S=2048),
through csrc/siren_decode_bf16.cu (asserted, as for every bf16 2C launch of phases 4 and 24, by the
kernel's own launch count), its bound at the bf16 peak with the sine epilogue's floor beside it
(tools/bf16_epilogue_floor.py), its launches the study's and the root tools'. The `(bf16)` entries of 2D, 2F and 2E are their bf16
modes at phase 3's timing shapes, with fp32_ms (the fp32 mode beside it) and the launches of phase 3's
drive; 2D's bound is at the bf16 peak, 2E's and 2F's at the TF32 peak (their products are fp32, as
in JAX: bf16 activations times fp32 weights), 2E's output bytes halved. 2D's, 2E's and 2F's bf16 launches go
through their Hopper kernels (csrc/siren_decode_act16.cu, csrc/siren_attention_wgmma.cu: on wgmma, three exact
bf16 pieces a weight for 2E and 2F, one rounded piece for 2D), asserted by those kernels' own launch counts;
their entries add stack_ms (the layer stack's kBF16 or kAct16 instance on the same call, sampled in turn with
the kernel), device_ms (torch.profiler's device time a call: the split pass, the kernel, the merge; null
where no profiler session recorded exactly those kernels once a call) and epilogue_floor_fast_ms (their
sines' epilogue alone, tools/bf16_epilogue_floor.py); the floor of their
products as bf16 passes at the bf16 peak is printed on phase 3's lines and kept out of the kernels' line,
being worked out rather than measured.

It ends with the kernels' JSON line, the nvidia-smi line and the JSON result.
The TPU package is not imported.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import json
import math
import struct
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
# The decode stack's 3xTF32 products round three times at ~2^-22 of a product where fp32 rounds once at 2^-24, so
# against an fp64 forward of the same params 2B/2C err more than the plain fp32 version: 1.6-7.3x its largest error
# on phase 22's 48 decodes (tiny to large, deep, hifreq; N=1-40, S=512-8192), up to 2.6e-5 where DECODE_TOL allows
# 2e-5 + 1e-5 |want| (large, deep, hifreq at N=40, S=1979). Phase 22 holds each decode to this multiple of the plain
# version's own error against the fp64 forward; a fault in a tile would err by orders of magnitude more.
FP64_GAIN = 16.0
# Phase 24's trained FM fits (check_train_fp64): at FM x64 the fp32 plain version's gradients err up to 4.1e-3 from a
# float64 autograd, and 2A's gradients 1.4e-4 to 3.1e-4 from the plain version's, so 2A is held element by element to
# the plain version at FM_GRAD_TOL, and leaf by leaf (each W_i or b_i across the nets) to the fp64 gradients at
# FM_LEAF_GAIN times the larger of the plain version's error in that leaf and FM_LEAF_FLOOR of the leaf's largest
# fp64 gradient. Measured over phase 24's 11 FM fits (NVIDIA H100 80GB HBM3, 700 W): 2A erred 0.91-1.24x the plain
# version in the first layer, 1.19-3.25x in the hidden leaves at FM x2-x8 (its 3xTF32 products, as in 2B/2C),
# 0.81-1.30x at x16-x64, and up to 8.9x in the output W, where that is at most 1.9e-5 of the leaf's largest gradient;
# no leaf above 0.81 of its limit. A zeroed leaf errs by its largest gradient: 4200x its limit or more there.
FM_GRAD_TOL = dict(rtol=1e-3, atol=5e-4)
FM_LEAF_GAIN = 4.0
FM_LEAF_FLOOR = 5e-5
KV_TOL = dict(rtol=1e-4, atol=2e-5)
LOGZ_ATOL = 1e-4  # the log-partition m + log l of the (m, l) stats
ATTN_SEQ_LENS = (2048, 32768)
SCHEMES = ("int8_g32", "int6_g64", "int4_g128")
LIBRARIES = ("siren_decode", "siren_decode_bf16", "siren_train", "siren_attention", "siren_attention_bf16",
             "siren_attention_act16", "siren_decode_act16", "siren_attention_wgmma", "kv_quant_attention",
             "mla_absorbed_attention")
HOST_LIBRARY = "synthkv"  # csrc/synthkv.cpp, the synthetic cache generator, built with g++
# What phases 4-5 (the study) launch: 2A, 2B, 2C and 2E in fp32, 2C's bf16 mode, the host generator. The other
# libraries go on compiling while the study runs, and phase 3 waits for them.
STUDY_LIBRARIES = ("siren_train", "siren_decode", "siren_decode_bf16", HOST_LIBRARY)

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
MLA_EDGE_HEADS = (4, 128)  # fewer heads than one 16-head group of the kernel; DeepSeek-V3's 128 (eight groups)
MLA_SCHEMES = ("int8_g32", "int6_g64", "int4_g64")
# Of the tool's 1024/4096/16384/32768 (each rung ~25 s): the first is where its legs are held to each other.
MLA_LADDER = (1024, 32768)
MLA_LADDER_SCHEMES = ("int8_g32", "int4_g64")
MLA_TOL = dict(rtol=1e-5, atol=2e-5)  # tests/test_torch_cuda.py: fp32 sums in another order
# bf16: the kernel rounds each softmax weight relative to the running max
# after its tile, the plain version relative to the global max (2^-9 of each
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


# The plan-rollout slice: Llama-3.1-8B (huggingface.co/meta-llama/Llama-3.1-8B config.json), cut to 4 layers
# (the JAX tool's depth is 8; half of it keeps the script inside its time) and a 4096-row vocabulary.
LLAMA_31_8B = dict(
    model_type="llama", vocab_size=4096, hidden_size=4096, intermediate_size=14336, num_hidden_layers=4,
    num_attention_heads=32, num_key_value_heads=8, head_dim=128, hidden_act="silu", rms_norm_eps=1e-5,
    rope_theta=500000.0, max_position_embeddings=131072, attention_bias=False, mlp_bias=False,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
)
PLAN_REPS = 2  # --timing_reps: 2 back-to-back rollouts a timing sample, of the tool's 5 on the card
PLAN_CUTS = ["layers 4 of 32", "vocabulary 4096 of 128256 (a step reads one embedding row; no LM head)",
             "seeds 1 of 3 (seed 0)", f"timing reps {PLAN_REPS} of 5"]
PLAN_SEQ_LEN, PLAN_NETS = 512, 128  # the tool's S; 2 x 64 units, the most nets a recon leg decodes at its 8 layers
# (hidden, hidden layers, D) of nets the SIREN kernels take only with zero units added: 2A's wrapper pads them
# (ops/_launch.py:pad_stack), the decode stack reads the units past the true widths as zeros.
PADDED_SHAPES = ((96, 1, HEAD_DIM), (64, 0, HEAD_DIM), (64, 1, 3), (72, 2, 18), (32, 14, 16))
# Nets wider than a 16-row tile's accumulators hold: the decode stack's wide tile. 3632 is the widest the
# fp32 SIMT stack before it took (two 8-row activation buffers in shared memory).
WIDE_SHAPES = ((2048, 1, HEAD_DIM), (3632, 0, 100))
DECODE_QUANT_SCHEMES = ("int8_g32", "int6_g64", "int4_g128", "int4_g32", "int8_g32_l0fp32")

# The hybrid engine (models/llama_hybrid.py) at LLAMA_31_8B's widths. 2F's shape there: `small` nets, the query
# group of 4 as T, the served heads of a layer as N, the whole window with stats. The wrapper plans tiles and chunks
# from N, so every N a layer can serve is held at phase 13's S=512 (its plans serve 0-8 heads a layer), and at phase
# 15's S the N it serves (4: every other KV head) beside 1 and 8.
HYBRID_GROUP = 4
HYBRID_2F_CASES = tuple((n, 512) for n in range(1, 9)) + tuple((n, s) for s in (2048, 32768) for n in (1, 4, 8))
HYBRID_2F_SCHEMES = ("fp32", "int8_g32", "int4_g128")
HYBRID_SEQ_LENS, HYBRID_SCHEMES = (2048, 32768), ("fp32", "int4_g128")
QUANTCACHE_CASES = ((32768, "int4_g128"), (2048, "int8_g32"), (2048, "int6_g64"), (2048, "int4_g128"))
HYBRID_LEG_SCHEMES = ["fp32", "int8_g32", "int4_g128"]  # phase 13's --hybrid legs: fp32, then the plan's schemes
HYBRID_PARITY_FLOOR = 0.9999  # cosine of a hybrid rollout against its buffer-swap twin (the JAX record: 0.99991+)
GARBAGE_ROWS = 64  # rows past S, filled with garbage, that the hybrid step must mask
# tests/test_llama_hybrid.py (hidden states) and tests/test_kv_quant_pallas.py (the appended rows): fp32 sums in
# another order. It also holds a longer buffer against the exact one, where the masked rows weigh exactly 0 and
# only the sums' length differs: on the CPU the two are equal bit for bit, but on the card cuBLAS splits an
# (S+64)-long product otherwise than an S-long one, and at these widths h reaches |h| ~ 25 after 8 layers (6e-5
# apart at S=2048, 2.3e-6 of the largest |h|; the CPU test's 1e-6 does not hold). The garbage rows are
# N(0, 1e6): visible, they would move h by orders of magnitude more.
H_TOL = dict(rtol=1e-4, atol=2e-4)
# The appended K/V rows of layers 1-7 are one projection of h and carry its differences: at these widths |k| and
# |v| reach ~5 (~0.1 in the CPU test), and the rows lie up to 1.8e-5 apart (3.5e-6 of their largest magnitude), so
# the CPU tests' atol 1e-5 does not hold; they are held to h's tolerance (atol 20x, rtol 1e-4 in place of 0).
ROW_TOL = H_TOL

# The study (phases 4-6): nerf_attention_tpu_torch.study on the synthetic reference recipe at its defaults but the
# epochs, cut from 2000 as phase 4 always was: 32 layers, 8 KV heads, S=2048, D=128, the 280-fit sweep, the
# scaling ladder 512-8192, four prompts, the SVD grid, the 32-layer profile and the 512-net aggregate decode.
STUDY_EPOCHS = 200
STUDY_CUTS = [f"epochs {STUDY_EPOCHS} of 2000 (every stage that fits)"]
SCALING_LADDER = (512, 1024, 2048, 4096, 8192)
PROMPTS = ("fiction", "code", "conversational", "technical")
# Quantized storage (phases 3-6): the study's quantize experiment at its defaults (the 40 medium checkpoints,
# the 7 schemes of EXPERIMENT_SCHEMES, 300 QAT epochs at N=40) and its opt-in compress stage at the measured
# frontier point, int4_g128 after the QAT repair (300 epochs).
STUDY_COMPRESS, QAT_EPOCHS = "int4_g128_qat", 300
QUANT_SCHEMES = ("fp32", "bf16", "fp16", "int8", "int4", "int8_g32_l0fp32", "int4_qat")
FP32_GUARD = 0.02  # the experiment's own guard: an fp32 row's CosSim against the sweep's record
QUANT_RECORD_KEYS = ("name", "layer", "head", "kv_type", "scheme", "stored_bytes", "compression_ratio",
                     "final_cosine_mean", "final_cosine_min", "seq_len", "d_head")
PAYLOAD_SCHEMES = ("int4_g128", "int8_g32")  # 2E on a compressed checkpoint's payload against 2C on it reloaded
# 2A and 2C with coordinates pinned to a longer cache (phase 3): the incremental experiment's absolute convention.
TOTAL_LEN, TOTAL_LEN_SEQ_LENS, TOTAL_LEN_NETS = 4096, (2304, 4096), 4
# The incremental experiment (phase 17): the study's cache geometry grown 2048 -> 4096 by 256, layer 8, 2 heads'
# K and V (N=4), medium nets, both coordinate conventions; cut: the epochs.
INCR_FINAL, INCR_CHUNK, INCR_EPOCHS, INCR_WARM = 4096, 256, 200, 100
INCR_CUTS = [f"epochs {INCR_EPOCHS} of 2000", f"warm epochs {INCR_WARM} of 1000"]
INCR_SNAPSHOTS = len(range(SEQ_LEN, INCR_FINAL + 1, INCR_CHUNK))
# The keys of every JSON artifact the JAX study writes on this path (tests/test_torch_study_e2e.py holds the
# port's to the JAX package's on the CPU): per file, the keys of the object, of each record (a list), or of
# each entry (an object of per-length or per-prompt records).
METADATA_KEYS = ("model_name", "num_layers", "num_kv_heads", "seq_len", "head_dim", "actual_tokens", "dtype")
FIT_KEYS = ("name", "layer", "head", "kv_type", "config_name", "hidden_features", "hidden_layers", "omega_0",
            "final_mse", "final_cosine_mean", "final_cosine_min", "final_cosine_std", "compression_ratio",
            "raw_size_bytes", "siren_size_bytes", "train_time_seconds", "num_parameters", "seq_len", "d_head")
SWEEP_META_KEYS = ("epochs", "lr", "seed", "quick", "seq_len", "kv_dir", "sin_impl", "fm_mult", "impl")
ANALYSIS_KEYS = ("metadata", "layer_summaries", "assessment")
STUDY_JSON = {
    "kv_cache/metadata.json": ("object", METADATA_KEYS),
    "analysis/analysis_results.json": ("object", ANALYSIS_KEYS),
    "fits/fit_results.json": ("records", FIT_KEYS),
    "fits/sweep_meta.json": ("object", SWEEP_META_KEYS),
    # compress's drop-in fits directory: the sweep's records re-priced, storage_scheme and qat added.
    f"fits_{STUDY_COMPRESS}/fit_results.json": ("records", FIT_KEYS + ("storage_scheme", "qat")),
    f"fits_{STUDY_COMPRESS}/sweep_meta.json": ("object", SWEEP_META_KEYS),
    "figures/latency_results.json": ("records", (
        "name", "config", "siren_time_ms", "siren_time_iqr_ms", "siren_time_fastsin_ms", "siren_time_fastsin_iqr_ms",
        "hbm_time_measured_ms", "hbm_time_measured_iqr_ms", "hbm_backend", "hbm_time_4060_ms", "hbm_time_h100_ms",
        "hbm_time_v5e_ms", "speedup_vs_4060", "speedup_vs_h100", "speedup_vs_v5e", "num_params")),
    "figures/crossover_data.json": ("object", (
        "siren_fit_log_slope", "siren_fit_log_intercept", "siren_scaling", "hbm_scaling", "latency_ratio_range",
        "latency_ratio_range_v5e", "latency_ratio_range_measured", "crossover_4060_tokens", "crossover_h100_tokens",
        "crossover_v5e_tokens", "note")),
    "scaling/scaling_results.json": ("entries", (
        "seq_len", "head_dim", "actual_tokens", "autocorr_keys", "autocorr_values", "spectral_keys",
        "spectral_values", "avg_cossim_keys", "avg_cossim_values", "avg_compression", "siren_time_ms",
        "hbm_measured_ms", "hbm_4060_ms", "hbm_h100_ms", "hbm_v5e_ms", "num_experiments", "fm_mult")),
    **{f"scaling/seq_{s}/kv_cache/metadata.json": ("object", METADATA_KEYS) for s in SCALING_LADDER},
    **{f"scaling/seq_{s}/analysis/analysis_results.json": ("object", ANALYSIS_KEYS) for s in SCALING_LADDER},
    "multi_prompt/multi_prompt_results.json": ("entries", (
        "actual_tokens", "autocorr_keys", "autocorr_values", "spectral_keys", "spectral_values", "avg_cossim_keys",
        "avg_cossim_values", "std_cossim_keys", "std_cossim_values")),
    **{f"multi_prompt/{p}/kv_cache/metadata.json": ("object", METADATA_KEYS) for p in PROMPTS},
    **{f"multi_prompt/{p}/analysis/analysis_results.json": ("object", ANALYSIS_KEYS) for p in PROMPTS},
    "svd/svd_results.json": ("records", (
        "name", "method", "layer", "head", "kv_type", "rank", "target_compression", "actual_compression",
        "final_cosine_mean", "final_cosine_min", "final_cosine_std", "raw_size_bytes", "svd_size_bytes", "seq_len",
        "d_head", "accounting")),
    "layer_profile/full_layer_profile.json": ("records", ("layer", "kv_type", "final_cosine_mean",
                                                          "compression_ratio")),
    # The _qat rows add qat_epochs after the scheme.
    "quantized_params/quantization_results.json": ("records", (
        QUANT_RECORD_KEYS, QUANT_RECORD_KEYS[:5] + ("qat_epochs",) + QUANT_RECORD_KEYS[5:])),
    f"fits_{STUDY_COMPRESS}/compress_manifest.json": ("object", (
        "scheme", "qat", "checkpoints", "verified_cosine_mean", "total_fp32_param_bytes", "total_stored_param_bytes",
        "param_compression_vs_fp32")),
    "aggregate_decode/aggregate_decode.json": ("object", (
        "num_networks", "seq_len", "head_dim", "weights_source", "fm_mult", "total_siren_params", "cache_bytes_bf16",
        "siren_aggregate_ms", "siren_aggregate_bf16_ms", "siren_aggregate_fastsin_ms", "hbm_measured_aggregate_ms",
        "hbm_slice_extrapolated_ms", "hbm_v5e_theoretical_ms", "hbm_h100_theoretical_ms", "hbm_4060_theoretical_ms",
        "ratio_vs_measured", "ratio_bf16_vs_measured", "ratio_fastsin_vs_measured", "ratio_vs_v5e_theoretical",
        "backend")),
    # The opt-in stages: --attention, then --serving's study and its two plans.
    "attention_error/attention_error_results.json": ("object", (
        "config", "epochs", "fm_mult", "seq_len", "n_queries", "seed", "matched_noise", "gains", "schemes", "layers",
        "wall_seconds")),
    "head_policy/head_policy_results.json": ("object", (
        "model", "net", "epochs", "seed", "fm_mult", "gain_lo", "gain_hi", "n_random", "uniform_entropy_nats", "units",
        "entropy_law_solo", "entropy_law_solo_2factor", "entropy_law_solo_cache", "entropy_law_solo_sink3", "sink_lo",
        "sink_hi", "law_curve_additivity", "serve_plan_validation", "tiered_plan_validation", "moe_routing",
        "payloads", "wall_seconds")),
    "serve_plan.json": ("object", (
        "cost_target", "safety", "n_units", "n_served", "predicted_cost_at_cut", "predicted_output_cosine_at_cut",
        "raw_bytes_served", "stored_bytes_served", "net_bytes_saved", "plan", "caveats")),
    "serve_plan_tiered.json": ("object", (
        "tiered", "cost_target", "safety", "n_units", "n_served", "n_skipped_net_negative", "predicted_cost_at_cut",
        "predicted_output_cosine_at_cut", "raw_bytes_served", "stored_bytes_served", "net_bytes_saved", "plan",
        "caveats")),
}
# The card's analysis and SVD against the port's own on the CPU (cuFFT and cuSOLVER against pocketfft and
# LAPACK, fp32 both): tests/test_torch_analyze.py's atol. A layer summary's rank ratio is a mean of counts at
# the 0.99 cut, where one of a layer's 8 tensors may count one more on one side: 1 / (D x 4 heads).
STUDY_ATOL = 1e-5
RANK_RATIO_ATOL = 1 / (HEAD_DIM * 4)
# An SVD record's min and std over its 2048 rows' cosines are held to 1e-4: a row whose low-rank
# reconstruction is short, where near-equal singular values leave the truncated subspace to each library,
# moves its cosine by up to 7.1e-5 (min) and the rows' spread by 1.5e-5 (std) between cuSOLVER's and
# LAPACK's factors, while the mean moves 4.5e-6 at most (H100, this script's phase 5).
SVD_ROW_STAT_ATOL = 1e-4
# Kernel 2B/2C's bf16 mode against its plain version: 4 bf16 ulps of the largest |output|
# (tests/test_torch_siren_decode_bf16.py; the plain version against JAX's bf16 kernel there).
BF16_ULPS = 4

# The rest of the study (phases 4-6, 18-20). experiments attention_error's defaults: layers 0/8/17/31, 2 heads'
# K and V (N=4 a fit), medium nets, 256 causal queries, gains 1/8/32/64.
ATTN_LAYERS, ATTN_HEADS, ATTN_QUERIES, ATTN_GAINS = (0, 8, 17, 31), 2, 256, (1.0, 8.0, 32.0, 64.0)
# experiments head_policy's hermetic defaults: 8 layers x 4 KV heads (64 `small` nets of D=32), S=512, its default
# scheme.
HP_LAYERS, HP_KV, HP_PAYLOADS = 8, 4, ("master", "int8_g32_l0fp32")
HP_SEQ, HP_DIM = 512, 32
ATTN_STORED_SCHEMES = ("int8_g32", "int4_g128_qat")  # phase 18, QAT_EPOCHS of straight-through repair
# Phase 19: the card against the CPU from the same initial params and queries (both packages' seeds draw them on
# the host). A fit's numbers are held to 1e-4 (2A's fp32 products in another order than the plain version's
# over 10-20 steps; phase 3 holds a 30-epoch fit's cosines to 2e-3), the entropies of the exact weights to 1e-5,
# and a top-1 agreement to 1/128: at most 4 of the 512 (query, head) argmaxes of a layer may flip where two
# weights lie within rounding.
CARD_CPU_ATTN = dict(layers=(8,), epochs=20, verbose=False)
CARD_CPU_HP = dict(seq_len=48, n_queries=4, epochs=10, config_name="tiny", num_layers=2, num_heads=4,
                   num_kv_heads=2, head_dim=16, hidden_size=64, intermediate_size=128, schemes=("fp16",),
                   budget_points=2, n_random=1, seed=0, verbose=False)
CARD_CPU_TOL = {"fit": 1e-4, "entropy": 1e-5, "top1": 1 / 128, "law": 1e-3}
# The head-policy study's entropy laws fit log(cost): a cost of 4e-6 moved by 1e-9 moves its log by 2.5e-4, so
# their coefficients and R^2 are held to 1e-3 (tests/test_torch_head_policy.py's LAW_ATOL).
LAW_FIELDS = ("slope", "intercept", "r2", "entropy_slope", "log1mproxy_slope")
# Phase 20: Llama-3.1-8B's attention widths (huggingface.co/meta-llama/Llama-3.1-8B config.json) in the
# experiment's own model (plain RoPE: run_head_policy_experiment takes no rope fields; vocabulary 512).
SERVE_8B = dict(num_heads=32, num_kv_heads=8, head_dim=128, hidden_size=4096, intermediate_size=14336)
SERVE_8B_LAYERS, SERVE_8B_SEQ, ENTROPY_8B_SEQ = 1, 512, 2048
SERVE_8B_CUTS = [f"layers {SERVE_8B_LAYERS} of 32", "vocabulary 512 of 128256 (the experiment's own model)",
                 f"epochs {STUDY_EPOCHS} of 2000"]
# Phase 21: the Llama families and the HF loaders at GPT-OSS-20B's widths (huggingface.co/openai/gpt-oss-20b
# config.json: attention sinks, biased projections, alternating 128-row windows starting sliding, YaRN, 32 experts
# top-4 with the clamped swiglu), cut to its first two layers (one sliding, one full) and a 4096-row vocabulary:
# 1.65 G parameters, 3.3 GB in bf16.
GPT_OSS_20B = dict(
    model_type="gpt_oss", vocab_size=4096, hidden_size=2880, intermediate_size=2880, num_hidden_layers=2,
    num_attention_heads=64, num_key_value_heads=8, head_dim=64, num_local_experts=32, num_experts_per_tok=4,
    sliding_window=128, layer_types=["sliding_attention", "full_attention"], rope_theta=150000.0,
    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0, "truncate": False,
                  "original_max_position_embeddings": 4096},
    rms_norm_eps=1e-5, max_position_embeddings=131072, attention_bias=True, hidden_act="silu", swiglu_limit=7.0,
    tie_word_embeddings=False)
FAMILY_CUTS = ["layers 2 of 24 (the first sliding / full pair)",
               "vocabulary 4096 of 201088 (a step reads one embedding row; no LM head is run)"]
FAMILY_SEQ = 2048
# The decode step at position S against the prefill of S + 1 tokens, both bf16: the prefill's chunked attention
# and the step's cache attention round their products and softmax weights to bf16 at other points (2^-8 of each),
# and layer 1's new row carries layer 0's output. A new row is held to this share of its largest magnitude, its
# cosine to 0.999.
FAMILY_BF16_REL = 0.03
# Phase 25, the mesh: the sweep at phase 4's cut; 2C over the aggregate decode's 512 nets (32 layers x 8 heads x
# {K, V}); 2D and 2F at the ladder's 8 medium heads, 2E at the plan path's 128 `small` nets; back-to-back calls a
# timing (the unsharded kernel alone on rank 0 while the other ranks wait). The SP prefill at Llama-3.1-8B's widths
# (LLAMA_31_8B) cut as phase 22 cuts it, to 2 layers here, at S=8192 in bf16, held to the single-device prefill at
# phase 21's bf16 share.
MESH_DECODE_NETS, MESH_ATTN_SEQS, MESH_QUANT_SCHEME = 512, (2048, 32768), "int4_g128"
MESH_REPS, MESH_DECODE_REPS = 11, 3  # timed calls a case (2C's: up to ~0.9 s a call with two Gloo ranks)
SP_SEQ, SP_LAYERS = 8192, 2
SP_CUTS = [f"layers {SP_LAYERS} of 32", "vocabulary 4096 of 128256"]
# Tensor parallelism in phase 25: Llama-3.1-8B's widths at all 32 layers on NCCL ranks (2 on the Gloo ranks that
# share a card, whose sums go through host memory), the prefill at SP_SEQ, the step at SP_SEQ over a buffer of
# SP_SEQ + TP_ROLLOUT rows, a TP_ROLLOUT-token rollout over the prefill's last rows; GPT-OSS-20B's widths as phase
# 21 cuts them at FAMILY_SEQ with a GPT_OSS_ROLLOUT-token rollout. A world of one is held to the unsharded calls bit
# for bit; two ranks to K/V within FAMILY_BF16_REL and cosine 0.999, h within cosine TP_H_COSINE.
TP_ROLLOUT, GPT_OSS_ROLLOUT, TP_NCCL_LAYERS, TP_H_COSINE = 16, 8, 32, 0.9999
# The stress axes of experiments head_policy at its hermetic defaults (8 layers x 4 KV heads, S=512, 64 `small`
# nets, its default scheme), 200 epochs of 2000.
HP_AXES = ("--hp_experts 8", "--hp_experts 8 --hp_moe_style gpt_oss", "--hp_sinks", "--hp_window 128 --hp_nope",
           "--hp_softcap 30")


PHASE_SECONDS = {}  # each phase's seconds, in the order they ran
STARTED = time.perf_counter()


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"[{name}] done in {PHASE_SECONDS[name]:.2f}s", flush=True)
    # Also on standard error, with the seconds since the script started: the end of a run that was stopped shows
    # how far it got.
    print(f"[{name}] done in {PHASE_SECONDS[name]:.2f}s, {time.perf_counter() - STARTED:.1f}s since the start",
          file=sys.stderr, flush=True)


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


def tc_bound(flops: float, nbytes: float) -> dict:
    """``bound`` at the TF32 tensor-core peak (3xTF32 counted as one pass), with
    the fp32 peak's bound beside it as ``fp32_bound_ms``: the kernels on the
    SIREN layer stack (2A-2F)."""
    return {**bound(flops, nbytes, PEAK_TF32_FLOPS), "fp32_bound_ms": bound(flops, nbytes)["bound_ms"]}


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


def cosine(a, b) -> float:
    """The cosine of two tensors of any shape, flattened, in float64 on the host."""
    a, b = (x.double().reshape(-1).cpu().numpy() for x in (a, b))
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def check_2g(tag: str, got, want, bf16: bool) -> float:
    """Kernel 2G's (o_lat, entropy) against its plain version's on the same inputs: o_lat to MLA_TOL, or for a
    bf16 latent to MLA_BF16_REL of the case's largest |o_lat|; the entropy to MLA_TOL."""
    (o, ent), (want_o, want_ent) = got, want
    tol = dict(rtol=0, atol=MLA_BF16_REL * want_o.abs().max().item()) if bf16 else MLA_TOL
    return max(check_close(f"{tag} o_lat", o, want_o, **tol), check_close(f"{tag} entropy", ent, want_ent, **MLA_TOL))


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

    # 2F at the hybrid engine's shape: `small` nets, T = Llama-3.1-8B's query group, the served heads of a layer,
    # the whole window (causal=False) with stats, as models/llama_hybrid.py calls it.
    from nerf_attention_tpu_torch.tools.measure_attention_decode import attention_inputs as inputs_of
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    small = CONFIGS_BY_NAME["small"]
    for n, seq_len in HYBRID_2F_CASES:
        k, v, stats, q = inputs_of(small, n, HYBRID_GROUP, HEAD_DIM, torch.Generator().manual_seed(n + seq_len), dev)
        rows, chunks, _, _ = sa.plan(n, seq_len, HYBRID_GROUP, small.hidden_features, HEAD_DIM, True,
                                     torch.cuda.current_device())
        for sch in HYBRID_2F_SCHEMES:
            kw = dict(sin_impl="fast", causal=False, return_stats=True)
            tag = (f"2F[{sch}] small N={n} S={seq_len} T={HYBRID_GROUP} causal=False (hybrid; tile {rows} rows, "
                   f"{chunks} chunks)")
            packed = (sq.pack_resident_params(k.params(), sch), sq.pack_resident_params(v.params(), sch))
            o, m, l = sq.siren_attention_decode_quant(None, None, *stats, q, sch, small.omega_0, seq_len,
                                                      packed=packed, **kw)
            want_o, want_m, want_l = sq.siren_attention_decode_quant_plain(packed, *stats, q, small.omega_0,
                                                                           seq_len, **kw)
            torch.cuda.synchronize()
            e = check_close(tag, o, want_o, **ATTN_TOL)
            e = max(e, check_close(f"{tag} log-partition", m + torch.log(l), want_m + torch.log(want_l), rtol=0,
                                   atol=LOGZ_ATOL))
            err["siren_attention_decode_quant"] = max(err["siren_attention_decode_quant"], e)
            dequant = [SirenStack.from_params(sq.unpack_resident_params(*p)) for p in packed]
            fused = sa.siren_attention_decode_fused(*dequant, *stats, q, small.omega_0, seq_len, sin_impl="fast",
                                                    causal=False)
            diff = (o - fused).abs().max().item()
            print(f"  {tag} vs 2D on the host-dequantized weights: max_abs_diff={diff:.3e} (must be 0)")
            assert diff == 0.0, diff

    def check_2i(tag, q, pk, pv, pos):
        o, m, l = kq.kv_cache_attention_quant(q, pk, pv, pos, scale=q.shape[-1] ** -0.5, return_stats=True)
        want_o, want_m, want_l = kq.kv_cache_attention_quant_plain(q, pk, pv, pos, scale=q.shape[-1] ** -0.5,
                                                                   return_stats=True)
        torch.cuda.synchronize()
        e = check_close(tag, o, want_o, **KV_TOL)
        e = max(e, check_close(f"{tag} log-partition", m + torch.log(l), want_m + torch.log(want_l), rtol=0,
                               atol=LOGZ_ATOL))
        err["kv_cache_attention_quant"] = max(err["kv_cache_attention_quant"], e)
        return o, m, l

    # 2I at the ladder's 8 heads, D=128 (S 2048, 8192, 32768 and a ragged 300), T 1, 4 (the hybrid step's GQA
    # group at Llama-3.1-8B's widths), 8 and 16, every scheme, positions S, S - 37, 1 and 0.
    for seq_len in (*ATTN_SEQ_LENS, 8192, 300):
        ck, cv, q16 = random_cache(NUM_HEADS, seq_len, 16, dev, seed=seq_len)
        for sch in SCHEMES:
            pk, pv = kq.pack_kv_unit_stack(ck, sch), kq.pack_kv_unit_stack(cv, sch)
            for t in (1, 4, 8, 16):
                q = q16[:, :t].contiguous()
                for pos in (seq_len, seq_len - 37, 1):
                    check_2i(f"2I[{sch}] N={NUM_HEADS} S={seq_len} T={t} position={pos}", q, pk, pv, pos)
                o, m, l = kq.kv_cache_attention_quant(q, pk, pv, 0, scale=HEAD_DIM ** -0.5, return_stats=True)
                torch.cuda.synchronize()
                zero = (torch.equal(o, torch.zeros_like(o)) and torch.equal(l, torch.zeros_like(l))
                        and bool(torch.isfinite(m).all()))
                print(f"  2I[{sch}] N={NUM_HEADS} S={seq_len} T={t} position=0: o == 0, l == 0, finite = {zero}")
                assert zero
    # Widths 64 and 256 (the kernel's unswizzled rows and its two value-column blocks); a tile-64 pack of a
    # ragged cache (S=300 of 320 padded rows) and positions past S, which the port takes as S.
    gen = torch.Generator().manual_seed(5)
    for d, sch in ((64, SCHEMES[-1]), (256, SCHEMES[0])):
        ck, cv = (torch.randn(NUM_HEADS, 2048, d, generator=gen).to(dev) for _ in range(2))
        q = (torch.randn(NUM_HEADS, 4, d, generator=gen) * 0.4).to(dev)
        pk, pv = kq.pack_kv_unit_stack(ck, sch), kq.pack_kv_unit_stack(cv, sch)
        for pos in (2048, 2048 - 37, 1):
            check_2i(f"2I[{sch}] N={NUM_HEADS} S=2048 T=4 D={d} position={pos}", q, pk, pv, pos)
    ck, cv, q = random_cache(NUM_HEADS, 300, 4, dev, seed=64)
    pk, pv = kq.pack_kv_unit_stack(ck, "int4_g64", tile=64), kq.pack_kv_unit_stack(cv, "int4_g64", tile=64)
    at_s = check_2i(f"2I[int4_g64] N={NUM_HEADS} S=300 T=4 tile=64 position=300", q, pk, pv, 300)
    for pos in (300 - 37, 1):
        check_2i(f"2I[int4_g64] N={NUM_HEADS} S=300 T=4 tile=64 position={pos}", q, pk, pv, pos)
    for pos in (330, 320):
        past = kq.kv_cache_attention_quant(q, pk, pv, pos, scale=HEAD_DIM ** -0.5, return_stats=True)
        same = all(torch.equal(a, b) for a, b in zip(past, at_s))
        print(f"  2I[int4_g64] S=300 tile=64 position={pos} (past S): equal to position S = {same}")
        assert same

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
        "siren_attention_decode_fused": dict(**tc_bound(attn_flops, 2 * NUM_HEADS * pbytes + small), library_ms=None),
        "siren_attention_decode_quant": dict(
            **tc_bound(attn_flops, sum(sq.resident_param_bytes(p[0]) for p in packed) + small), library_ms=None),
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
    # 2I's own time at the ladder's longest cache (tools/kv_quant_kernel_times.py): on the device with the cache in
    # the L2 and read from device memory, against its bytes bound and SDPA over the fp32 cache, both on the device.
    from nerf_attention_tpu_torch.tools import kv_quant_kernel_times

    row = kv_quant_kernel_times.time_case(SCHEMES[-1], 1, ATTN_SEQ_LENS[-1], 2, dev)
    report["kv_cache_attention_quant"].update(
        device_ms=row["device_ms"], cold_device_ms=row["cold_device_ms"], device_bound_ms=row["bound_ms"],
        device_library_ms=row["sdpa_ms"],
        device_shape=f"N={NUM_HEADS}, S={ATTN_SEQ_LENS[-1]}, D={HEAD_DIM}, T=1, {SCHEMES[-1]} K/V, position S")
    print(f"  kv_cache_attention_quant ({report['kv_cache_attention_quant']['device_shape']}): "
          f"{row['device_ms']:.4f} ms on the device, {row['cold_device_ms']:.4f} from device memory, "
          f"bound {row['bound_ms']:.4f} ms (bytes), SDPA over the fp32 cache {row['sdpa_ms']:.4f} ms on the device")
    return report


def mla_inputs(s_buf: int, dev, seed: int, heads: int = MLA_H):
    """`heads` absorbed queries, an (S_buf, 576) latent and the new token's row, from a seed."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(heads, MLA_D, generator=gen) * 0.1).to(dev)
    return q, torch.randn(s_buf, MLA_D, generator=gen).to(dev), torch.randn(1, MLA_D, generator=gen).to(dev)


def mla_bytes_small(heads: int = MLA_H) -> int:
    """q, the new row, o_lat and the entropies (fp32)."""
    return 4 * (heads * MLA_D + MLA_D + heads * MLA_R + heads)


def check_mla_kernels(dev, median_ms) -> dict:
    """Kernels 2G and 2H against their plain versions, 2H against 2G on the
    host-dequantized latent, at V2-Lite's 16 heads (S_buf 1024, 32768, 300,
    0; two logit scales) and at 4 and 128 heads with rows at a tile's edge;
    their report entries (times at S=32768)."""
    import torch

    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma
    from nerf_attention_tpu_torch.ops import mla_quant_cuda as mq

    err = {"mla_absorbed_attention": 0.0, "mla_absorbed_attention_quant": 0.0}

    def hold_2g(tag, q, cache, new, pos, args):
        got = ma.mla_absorbed_attention(q, cache, new, pos, **args)
        want = ma.mla_absorbed_attention_plain(q, cache, new, pos, **args)
        torch.cuda.synchronize()
        e = check_2g(tag, got, want, cache.dtype == torch.bfloat16)
        err["mla_absorbed_attention"] = max(err["mla_absorbed_attention"], e)

    def check_2h(tag, q, packed, dequant, new, pos, args):
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

    for s_buf, scale in [(s, MLA_SCALES[0]) for s in MLA_SEQ_LENS] + [(s, MLA_SCALES[1]) for s in MLA_SEQ_LENS[:2]]:
        args = dict(kv_lora_rank=MLA_R, scale=scale)
        q, lat, new = mla_inputs(s_buf, dev, seed=s_buf)
        positions = sorted(p for p in {s_buf, s_buf - 37, 1, 0} if 0 <= p <= s_buf)
        for dtype in (torch.float32, torch.bfloat16):
            cache = lat.to(dtype)
            for pos in positions:
                hold_2g(f"2G {str(dtype)[6:]} H={MLA_H} S_buf={s_buf} position={pos} scale={scale:.5f}", q, cache,
                        new, pos, args)
        if s_buf == 0:
            continue  # an empty cache has nothing to pack
        for sch in MLA_SCHEMES:
            packed = mq.pack_resident_latent(lat, sch)
            dequant = mq.unpack_resident_latent(*packed)
            for pos in positions:
                check_2h(f"2H[{sch}] H={MLA_H} S_buf={s_buf} position={pos} scale={scale:.5f}", q, packed, dequant,
                         new, pos, args)

    # Fewer heads than a 16-head group and V3's 128 (eight groups); rows at a tile's edge (tile - 1, tile,
    # tile + 1 of the kernel's tile rows: 64 for a bf16 latent, 32 for fp32 and the packed codes).
    args = dict(kv_lora_rank=MLA_R, scale=MLA_SCALE)
    for heads in MLA_EDGE_HEADS:
        for dtype in (torch.float32, torch.bfloat16):
            for s_buf in (ma.TILE_ROWS[dtype] + e for e in (-1, 0, 1)):
                q, lat, new = mla_inputs(s_buf, dev, seed=heads + s_buf, heads=heads)
                for pos in (s_buf, s_buf - 5):
                    hold_2g(f"2G {str(dtype)[6:]} H={heads} S_buf={s_buf} position={pos}", q, lat.to(dtype), new,
                            pos, args)
                if dtype != torch.float32:
                    continue
                for sch in MLA_SCHEMES:
                    packed = mq.pack_resident_latent(lat, sch, tile=64)
                    dequant = mq.unpack_resident_latent(*packed)
                    for pos in (s_buf, s_buf - 5):
                        check_2h(f"2H[{sch}] H={heads} S_buf={s_buf} tile=64 position={pos}", q, packed, dequant,
                                 new, pos, args)

    # Times at the ladder's longest cache, position S: 2G over the bf16 latent, 2H over int4_g64 codes; 2G over
    # the fp32 latent is printed. ms: back-to-back calls, as for every kernel; device_ms: the kernel and its
    # merge on the device per call, each call's cache read from device memory.
    from nerf_attention_tpu_torch.tools.mla_kernel_times import cold_copies, cold_device_ms, sdpa_latent

    s_buf = MLA_LADDER[-1]
    q, lat, new = mla_inputs(s_buf, dev, seed=1)
    cache = lat.to(torch.bfloat16)
    packed = mq.pack_resident_latent(lat, "int4_g64")
    flops = 2 * MLA_H * (s_buf + 1) * (MLA_D + MLA_R)
    # The library yardstick (tools/mla_kernel_times.sdpa_latent): SDPA of the 16 heads (as 16 query rows) over the
    # latent rows, o_lat only (no entropy, no self row); for 2H over the host-dequantized latent.
    dequant = mq.unpack_resident_latent(*packed)
    runs = {
        "mla_absorbed_attention": (
            lambda c: ma.mla_absorbed_attention(q, c, new, s_buf, **args), cache,
            lambda: ma.mla_absorbed_attention_plain(q, cache, new, s_buf, **args),
            # bf16 operands (q, the weights and the cache rounded to bf16), fp32 sums: the tensor cores' type.
            bound(flops, s_buf * MLA_D * 2 + mla_bytes_small(), PEAK_BF16_FLOPS),
            median_ms(lambda: sdpa_latent(q, cache, MLA_SCALE), 50),
            f"H={MLA_H}, r={MLA_R}, rope={MLA_ROPE}, S_buf={s_buf}, position S, bf16 latent"),
        "mla_absorbed_attention_quant": (
            lambda ops: mq.mla_absorbed_attention_quant(q, (ops, packed[1]), new, s_buf, **args), packed[0],
            lambda: mq.mla_absorbed_attention_quant_plain(q, packed, new, s_buf, **args),
            # fp32 products on the tensor cores in 3xTF32 (counted once), the fp32 peak's bound beside it.
            tc_bound(flops, mq.resident_latent_bytes(packed[0]) + mla_bytes_small()),
            median_ms(lambda: sdpa_latent(q, dequant, MLA_SCALE), 50),
            f"H={MLA_H}, r={MLA_R}, rope={MLA_ROPE}, S_buf={s_buf}, position S, int4_g64 latent"),
    }

    def cold(run, operand) -> float:  # operand: a tensor or a list of them
        nbytes = sum(t.numel() * t.element_size() for t in (operand if isinstance(operand, list) else [operand]))
        clone = lambda: [t.clone() for t in operand] if isinstance(operand, list) else operand.clone()
        return cold_device_ms(run, [operand] + [clone() for _ in range(cold_copies(nbytes) - 1)])

    report = {}
    for name, (run, operand, plain, bnd, library_ms, what) in runs.items():
        report[name] = dict(max_abs_err=err[name], ms=median_ms(lambda: run(operand), 50),
                            device_ms=cold(run, operand), plain_ms=median_ms(plain, 20), shape=what,
                            library_ms=library_ms, **bnd)
        print(f"  {name} ({what}): kernel {report[name]['ms']:.4f} ms a call back to back, "
              f"{report[name]['device_ms']:.4f} ms on the device from device memory, plain "
              f"{report[name]['plain_ms']:.4f} ms, bound {report[name]['bound_ms']:.4f} ms ({report[name]['bound_by']}), "
              f"library {library_ms}")
    fp32_bound = tc_bound(flops, s_buf * MLA_D * 4 + mla_bytes_small())
    fp32_run = lambda c: ma.mla_absorbed_attention(q, c, new, s_buf, **args)
    print(f"  mla_absorbed_attention over the fp32 latent (S_buf={s_buf}): kernel {median_ms(lambda: fp32_run(lat), 50):.4f} "
          f"ms a call back to back, {cold(fp32_run, lat):.4f} ms on the device from device memory, bound "
          f"{fp32_bound['bound_ms']:.4f} ms ({fp32_bound['bound_by']}, TF32; fp32 peak {fp32_bound['fp32_bound_ms']:.4f} ms)")
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
    import torch

    from nerf_attention_tpu_torch.models import mla
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma

    config = mla.MLAConfig.from_hf_dict({**V2_LITE, "num_hidden_layers": 2})
    print(f"  {config.num_dense_layers} dense + {config.num_moe_layers} MoE layer ({config.n_routed_experts} "
          f"experts, top-{config.num_experts_per_tok}, {config.n_shared_experts} shared, width "
          f"{config.moe_intermediate_size}), bf16, S=4096, position 4096")
    t0 = time.perf_counter()
    params = v2_lite_params(draw_v2_lite(dev, config, seed=0), config)  # init_random_mla's numpy stream: ~20 s
    print(f"  random weights drawn on the card from seed 0: {time.perf_counter() - t0:.1f}s")
    gen = torch.Generator().manual_seed(4096)
    lat = (torch.randn(2, 4096, config.latent_dim, generator=gen) * 0.5).to(dev, torch.bfloat16)
    before = ma.launches["mla_absorbed_attention"]
    got = mla.mla_decode_step_absorbed(config, params, 7, 4096, lat, attn_impl="cuda")
    want = mla.mla_decode_step_absorbed(config, params, 7, 4096, lat)
    torch.cuda.synchronize()
    assert ma.launches["mla_absorbed_attention"] == before + 2
    cos, finite = cosine(got[0], want[0]), bool(torch.isfinite(got[0].float()).all())
    ent_gap = (got[2] - want[2]).abs().max().item()
    print(f"  h: cos(2G, plain) = {cos:.6f} (>= 0.999), finite = {finite}; entropy max abs gap = {ent_gap:.3e}")
    assert finite and cos >= 0.999, cos
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
        **tc_bound(2 * macs * PLAN_SEQ_LEN * PLAN_NETS,
                   sq.resident_param_bytes(packed[0]) + PLAN_NETS * PLAN_SEQ_LEN * HEAD_DIM * 4),
    )
    print(f"  siren_decode_batch_quant ({shape}): kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, "
          f"bound {report['bound_ms']:.4f} ms ({report['bound_by']}), library None")
    return report


def check_wide_nets(dev, median_ms) -> float:
    """Nets wider than a 16-row tile's accumulators hold, through the stack's
    wide tile: 2C and 2D against their plain versions, 2E and 2F equal to 2C
    and 2D on the host-dequantized weights, twice-runs equal; 2C's time at
    hidden 2048. Returns the largest decode error."""
    import torch

    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.types import SIRENConfig

    err = 0.0
    for hidden, layers, d_out in WIDE_SHAPES:
        config = SIRENConfig(hidden, layers, 30.0, "wide")
        gen = torch.Generator().manual_seed(hidden)
        k, v = (SirenStack.from_params(init_siren(config, d_out, generator=gen, n=2, device=dev)) for _ in "kv")
        tag = f"H={hidden} L={layers + 2} D={d_out} (wide)"
        for sin_impl, fm in (("exact", None), ("fast", 32.0)):
            kw = dict(sin_impl=sin_impl, fm_mult=fm)
            got = siren_cuda.siren_decode_batch(k, 30.0, 300, **kw)
            want = siren_cuda.siren_decode_plain(k, 30.0, 300, **kw)
            torch.cuda.synchronize()
            err = max(err, check_close(f"siren_decode_batch N=2 S=300 {tag} {sin_impl} fm={fm}", got, want,
                                       **DECODE_TOL))
            assert torch.equal(got, siren_cuda.siren_decode_batch(k, 30.0, 300, **kw))
        stats = [(torch.rand(2, 1, d_out, generator=gen) + 0.5).to(dev) for _ in range(4)]
        q = torch.randn(2, 4, d_out, generator=gen).to(dev)
        got = sa.siren_attention_decode_fused(k, v, *stats, q, 30.0, 300)
        want = sa.siren_attention_decode_plain(k, v, *stats, q, 30.0, 300)
        torch.cuda.synchronize()
        check_close(f"siren_attention_decode_fused N=2 S=300 T=4 {tag} fast causal", got, want, **ATTN_TOL)
        assert torch.equal(got, sa.siren_attention_decode_fused(k, v, *stats, q, 30.0, 300))
        packed = tuple(sq.pack_resident_params(s.params(), "int4_g128") for s in (k, v))
        dequant = [SirenStack.from_params(sq.unpack_resident_params(*p)) for p in packed]
        quant = sq.siren_decode_batch_quant(None, "int4_g128", 30.0, 300, packed=packed[0], sin_impl="fast")
        diff_2e = (quant - siren_cuda.siren_decode_batch(dequant[0], 30.0, 300, sin_impl="fast")).abs().max().item()
        quant = sq.siren_attention_decode_quant(None, None, *stats, q, "int4_g128", 30.0, 300, packed=packed)
        diff_2f = (quant - sa.siren_attention_decode_fused(*dequant, *stats, q, 30.0, 300)).abs().max().item()
        print(f"  2E / 2F int4_g128 {tag} vs 2C / 2D on the host-dequantized weights: max_abs_diff "
              f"{diff_2e:.3e} / {diff_2f:.3e} (must be 0)")
        assert diff_2e == 0.0 and diff_2f == 0.0, (diff_2e, diff_2f)
    config = SIRENConfig(2048, 1, 30.0, "wide")
    stack = SirenStack.from_params(init_siren(config, HEAD_DIM, generator=torch.Generator().manual_seed(1),
                                              n=NUM_HEADS, device=dev))
    macs, pbytes = siren_macs(stack.dims)
    ms = median_ms(lambda: siren_cuda.siren_decode_batch(stack, 30.0, SEQ_LEN), 10)
    plain_ms = median_ms(lambda: siren_cuda.siren_decode_plain(stack, 30.0, SEQ_LEN), 10)
    b = tc_bound(2 * macs * SEQ_LEN * NUM_HEADS, NUM_HEADS * (pbytes + SEQ_LEN * HEAD_DIM * 4))
    print(f"  siren_decode_batch hidden 2048, 3 layers, N={NUM_HEADS}, S={SEQ_LEN}, exact (wide tile): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, TF32 peak; "
          f"fp32 peak {b['fp32_bound_ms']:.4f} ms)")
    return err


def check_bf16(what: str, got, want) -> float:
    """Kernel 2B/2C's bf16 mode against its plain version: within BF16_ULPS bf16 ulps of the largest |want|."""
    import torch

    assert got.dtype == want.dtype == torch.bfloat16, (got.dtype, want.dtype)
    return check_ulps(what, got, want)


def check_study_shapes(dev, median_ms, stack_for, targets_for, check_train) -> dict:
    """Kernels 2A, 2B and 2C at the shapes the study gives them, each against its
    plain version with the CPU tests' tolerances and timed beside it: 2A at the
    scaling ladder's N=6 (S 512-8192) and the layer profile's N=64; 2B at S
    512-8192 and in bf16; 2C at the aggregate's N=512 in fp32 exact, fp32 fast and
    bf16, and in bf16 at N=40 and through the wide tile. Returns the bf16 mode's
    report entry (2C at N=512)."""
    import torch

    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren, layer_dims
    from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda
    from nerf_attention_tpu_torch.tools import bf16_epilogue_floor
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME, CONFIGS_FULL, SIRENConfig

    medium = CONFIGS_BY_NAME["medium"]
    macs, pbytes = siren_macs(layer_dims(medium, HEAD_DIM))
    kw = dict(omega=medium.omega_0, sin_impl="fast")
    for n, seq_len in [(6, s) for s in SCALING_LADDER if s != SEQ_LEN] + [(64, SEQ_LEN)]:
        stack, targets = stack_for(medium, n, seed=40 + n), targets_for(n, seq_len, seed=41)
        check_train(stack, targets, f"siren_train_grads medium N={n} S={seq_len} fast (study)", TRAIN_TOL["fast"], **kw)
        ms = median_ms(lambda: siren_train_cuda.siren_train_grads(stack, targets, **kw), 10)
        plain = median_ms(lambda: siren_train_cuda.siren_train_grads_plain(stack, targets, **kw), 5)
        b = tc_bound(6 * macs * seq_len * n, n * (seq_len * HEAD_DIM * 4 + 2 * pbytes + 4))
        print(f"  siren_train_grads medium N={n} S={seq_len}: kernel {ms:.4f} ms, plain {plain:.4f} ms per step, "
              f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}, TF32 peak)")

    one = stack_for(medium, 1, seed=43)
    for seq_len in SCALING_LADDER:
        got = siren_cuda.siren_decode(one, medium.omega_0, seq_len)
        want = siren_cuda.siren_decode_plain(one, medium.omega_0, seq_len)[0]
        torch.cuda.synchronize()
        check_close(f"siren_decode N=1 medium S={seq_len} exact (study)", got, want, **DECODE_TOL)
        ms = median_ms(lambda: siren_cuda.siren_decode(one, medium.omega_0, seq_len), 50)
        plain = median_ms(lambda: siren_cuda.siren_decode_plain(one, medium.omega_0, seq_len), 20)
        b = tc_bound(2 * macs * seq_len, pbytes + seq_len * HEAD_DIM * 4)
        print(f"  siren_decode N=1 S={seq_len}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}, TF32 peak)")
    bf16 = dict(compute_dtype=torch.bfloat16)
    before = siren_cuda.wgmma_launches["siren_decode"]
    check_bf16(f"siren_decode N=1 medium S={SEQ_LEN} exact bf16", siren_cuda.siren_decode(one, 30.0, SEQ_LEN, **bf16),
               siren_cuda.siren_decode_plain(one, 30.0, SEQ_LEN, **bf16)[0])
    assert siren_cuda.wgmma_launches["siren_decode"] == before + 1  # csrc/siren_decode_bf16.cu
    ms = median_ms(lambda: siren_cuda.siren_decode(one, 30.0, SEQ_LEN, **bf16), 50)
    plain = median_ms(lambda: siren_cuda.siren_decode_plain(one, 30.0, SEQ_LEN, **bf16), 20)
    b = bound(2 * macs * SEQ_LEN, pbytes + SEQ_LEN * HEAD_DIM * 2, PEAK_BF16_FLOPS)
    print(f"  siren_decode N=1 S={SEQ_LEN} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b['bound_ms']:.5f} "
          f"ms ({b['bound_by']}, bf16 peak)")

    n = NUM_LAYERS * NUM_HEADS * 2  # the aggregate decode: every (layer, head, K|V) of the cache
    big = stack_for(medium, n, seed=44)
    report = None
    rule = {c.name: siren_cuda.bf16_route(c.hidden_features, HEAD_DIM) for c in CONFIGS_FULL}
    print(f"  bf16 mode's width rule (ops/siren_cuda.py:bf16_route): hidden padded to "
          f"{siren_cuda.WGMMA_HIDDEN_MULT} and output width at most {siren_cuda.WGMMA_MAX_WIDTH}, both multiples of "
          f"{siren_cuda.WGMMA_WIDTH_MULT} -> "
          f"csrc/siren_decode_bf16.cu (\"wgmma\"), else the layer stack of csrc/siren_decode.cu (\"stack\"): {rule}; "
          f"hidden 2048 -> {siren_cuda.bf16_route(2048, HEAD_DIM)}")
    assert all((route == "stack") == (c.hidden_features > 256) for c, route in zip(CONFIGS_FULL, rule.values()))
    for sin_impl, dtype in (("exact", torch.float32), ("fast", torch.float32), ("exact", torch.bfloat16)):
        kwd = dict(sin_impl=sin_impl, compute_dtype=dtype)
        tag = f"siren_decode_batch N={n} medium S={SEQ_LEN} {sin_impl} {str(dtype)[6:]} (aggregate)"
        before = siren_cuda.wgmma_launches["siren_decode_batch"]
        got = siren_cuda.siren_decode_batch(big, 30.0, SEQ_LEN, **kwd)
        assert siren_cuda.wgmma_launches["siren_decode_batch"] == before + (dtype == torch.bfloat16), tag
        want = siren_cuda.siren_decode_plain(big, 30.0, SEQ_LEN, **kwd)
        torch.cuda.synchronize()
        err = check_bf16(tag, got, want) if dtype == torch.bfloat16 else check_close(tag, got, want, **DECODE_TOL)
        del got, want
        ms = median_ms(lambda: siren_cuda.siren_decode_batch(big, 30.0, SEQ_LEN, **kwd), 10)
        plain = median_ms(lambda: siren_cuda.siren_decode_plain(big, 30.0, SEQ_LEN, **kwd), 3)
        out_bytes = n * SEQ_LEN * HEAD_DIM * (2 if dtype == torch.bfloat16 else 4)
        b = (bound(2 * macs * SEQ_LEN * n, n * pbytes + out_bytes, PEAK_BF16_FLOPS) if dtype == torch.bfloat16
             else tc_bound(2 * macs * SEQ_LEN * n, n * pbytes + out_bytes))
        print(f"  {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
              f"{'bf16' if dtype == torch.bfloat16 else 'TF32'} peak)")
        if dtype == torch.bfloat16:
            floor = bf16_epilogue_floor.floor(n * SEQ_LEN * 3 * medium.hidden_features, dev)
            print(f"  the bf16 kernel's epilogue floor (tools/bf16_epilogue_floor.py) at this shape: exact sine "
                  f"{floor['exact']['probe_ms']:.4f} ms ({floor['exact']['loop_instructions']} SASS instructions a "
                  f"32-value trip, {floor['exact']['issue_ms']:.4f} ms at one a cycle), fast "
                  f"{floor['fast']['probe_ms']:.4f} ms ({floor['fast']['loop_instructions']}, "
                  f"{floor['fast']['issue_ms']:.4f} ms); bound {b['bound_ms']:.4f} ms; the kernel {ms:.4f} ms")
            report = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                          epilogue_floor_ms=floor["exact"]["probe_ms"],
                          epilogue_floor_fast_ms=floor["fast"]["probe_ms"],
                          shape=f"medium, N={n}, S={SEQ_LEN}, D={HEAD_DIM}, exact sine, bf16 mode "
                                f"(csrc/siren_decode_bf16.cu)", **b)
    del big
    mid = stack_for(medium, N_FITS, seed=45)
    report["max_abs_err"] = max(report["max_abs_err"], check_bf16(
        f"siren_decode_batch N={N_FITS} medium S={SEQ_LEN} fast bf16",
        siren_cuda.siren_decode_batch(mid, 30.0, SEQ_LEN, sin_impl="fast", **bf16),
        siren_cuda.siren_decode_plain(mid, 30.0, SEQ_LEN, sin_impl="fast", **bf16)))
    wide = SirenStack.from_params(init_siren(SIRENConfig(2048, 1, 30.0, "wide"), HEAD_DIM,
                                             generator=torch.Generator().manual_seed(46), n=NUM_HEADS, device=dev))
    report["max_abs_err"] = max(report["max_abs_err"], check_bf16(
        f"siren_decode_batch N={NUM_HEADS} hidden 2048 S=300 exact bf16 (wide tile)",
        siren_cuda.siren_decode_batch(wide, 30.0, 300, **bf16), siren_cuda.siren_decode_plain(wide, 30.0, 300, **bf16)))
    return report


def check_total_len(stack_for, targets_for, check_train) -> tuple[float, float]:
    """2A and 2C with coordinates pinned to a longer cache (s / (total_len - 1)) against their plain versions at
    the incremental experiment's shapes (medium, N=4, S 2304 and 4096, total_len 4096), with the CPU tests'
    tolerances; and total_len = S equal bit for bit to the default coordinates, the parent's s / (S - 1).
    Returns (2A's, 2C's) largest errors."""
    import torch

    from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    medium = CONFIGS_BY_NAME["medium"]
    train_err = decode_err = 0.0
    for seq_len in TOTAL_LEN_SEQ_LENS:
        stack = stack_for(medium, TOTAL_LEN_NETS, seed=seq_len)
        targets = targets_for(TOTAL_LEN_NETS, seq_len, seed=seq_len + 1)
        for sin_impl in ("fast", "exact"):
            tag = f"N={TOTAL_LEN_NETS} medium S={seq_len} total_len={TOTAL_LEN} {sin_impl}"
            kw = dict(omega=medium.omega_0, sin_impl=sin_impl)
            train_err = max(train_err, check_train(stack, targets, f"siren_train_grads {tag}", TRAIN_TOL[sin_impl],
                                                   total_len=TOTAL_LEN, **kw))
            got = siren_cuda.siren_decode_batch(stack, medium.omega_0, seq_len, sin_impl=sin_impl, total_len=TOTAL_LEN)
            want = siren_cuda.siren_decode_plain(stack, medium.omega_0, seq_len, sin_impl=sin_impl,
                                                 total_len=TOTAL_LEN)
            torch.cuda.synchronize()
            decode_err = max(decode_err, check_close(f"siren_decode_batch {tag}", got, want, **DECODE_TOL))
            default = siren_cuda.siren_decode_batch(stack, medium.omega_0, seq_len, sin_impl=sin_impl)
            pinned = siren_cuda.siren_decode_batch(stack, medium.omega_0, seq_len, sin_impl=sin_impl,
                                                   total_len=seq_len)
            loss_d, grads_d = siren_train_cuda.siren_train_grads(stack, targets, **kw)
            loss_p, grads_p = siren_train_cuda.siren_train_grads(stack, targets, total_len=seq_len, **kw)
            same = (torch.equal(default, pinned) and torch.equal(loss_d, loss_p)
                    and torch.equal(grads_d.flat, grads_p.flat))
            print(f"  2A and 2C N={TOTAL_LEN_NETS} S={seq_len} {sin_impl}: total_len=S equal to the default "
                  f"coordinates bit for bit = {same}")
            assert same
    return train_err, decode_err


def check_compressed_payloads(stack_for) -> None:
    """Kernel 2E on ``pack_resident_params`` of checkpoints' master weights against 2C on the same checkpoints
    reloaded from compress's packed files (max abs diff 0), at each of PAYLOAD_SCHEMES: 4 medium nets, S=2048."""
    import torch

    from nerf_attention_tpu_torch import compress
    from nerf_attention_tpu_torch.io import checkpoint
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    medium = CONFIGS_BY_NAME["medium"]
    nets = stack_for(medium, 4, seed=60)
    host = [(w.cpu().numpy(), b.cpu().numpy()) for w, b in nets.params()]
    zero, one = np.zeros((1, HEAD_DIM), np.float32), np.ones((1, HEAD_DIM), np.float32)
    on_card = lambda params: [(torch.from_numpy(np.stack([p[i][0] for p in params])).to(nets.flat.device),
                               torch.from_numpy(np.stack([p[i][1] for p in params])).to(nets.flat.device))
                              for i in range(len(params[0]))]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_payload_") as tmp:
        fits = Path(tmp) / "fits"
        for i in range(nets.n):
            name = f"L0_H{i}_key_medium"
            checkpoint.save_siren_checkpoint(fits / f"{name}_model.npz", [(w[i], b[i]) for w, b in host], medium,
                                             HEAD_DIM, zero, one, {"name": name, "layer": 0, "head": i,
                                                                   "kv_type": "key"})
        for scheme in PAYLOAD_SCHEMES:
            out = Path(tmp) / scheme
            compress.main(["--siren_dir", str(fits), "--out_dir", str(out), "--scheme", scheme])
            files = checkpoint.checkpoint_glob(fits)
            master = [checkpoint.load_siren_checkpoint(f)["params"] for f in files]
            reloaded = [checkpoint.load_siren_checkpoint(out / f.name)["params"] for f in files]
            got = sq.siren_decode_batch_quant(None, scheme, medium.omega_0, SEQ_LEN,
                                              packed=sq.pack_resident_params(on_card(master), scheme))
            want = siren_cuda.siren_decode_batch(on_card(reloaded), medium.omega_0, SEQ_LEN)
            diff = (got - want).abs().max().item()
            print(f"  2E[{scheme}] on the master weights' resident payload vs 2C on the {len(files)} checkpoints "
                  f"reloaded from compress's {scheme} files: max_abs_diff={diff:.3e} (must be 0)")
            assert diff == 0.0, diff


@contextlib.contextmanager
def counted(module, name: str, calls: list):
    """``module.name`` replaced, inside the block, by a wrapper that appends (seconds, kernel 2A launches,
    kernel 2C launches, its ``seq_len`` argument) of each call to ``calls``: the share of a path's launches
    that one function made."""
    import torch

    from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda

    inner = getattr(module, name)

    def wrapper(*args, **kwargs):
        a0, c0 = siren_train_cuda.launches["siren_train_grads"], siren_cuda.launches["siren_decode_batch"]
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, siren_train_cuda.launches["siren_train_grads"] - a0,
                      siren_cuda.launches["siren_decode_batch"] - c0, kwargs.get("seq_len")))
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, inner)


@contextlib.contextmanager
def uncounted():
    """Launches of every kernel and mode inside the block left out of their counts: a kernel held against its
    plain version on a path's inputs is not a launch of that path."""
    from nerf_attention_tpu_torch.ops import (kv_quant_cuda, mla_absorbed_cuda, mla_quant_cuda, siren_attention_cuda,
                                              siren_cuda, siren_quant_cuda, siren_train_cuda)

    saved = [(counts, dict(counts)) for counts in (
        siren_train_cuda.launches, siren_cuda.launches, siren_cuda.bf16_launches, siren_cuda.wgmma_launches,
        siren_attention_cuda.launches, siren_attention_cuda.bf16_launches, siren_attention_cuda.wgmma_launches,
        siren_quant_cuda.launches, siren_quant_cuda.bf16_launches, siren_quant_cuda.wgmma_launches,
        kv_quant_cuda.launches, mla_absorbed_cuda.launches, mla_quant_cuda.launches)]
    try:
        yield
    finally:
        for counts, before in saved:
            counts.update(before)


def check_quantized(root: Path, data: dict) -> None:
    """The quantize experiment's records and compress's directory: 40 x 7 records with finite CosSim, the fp32
    rows within the experiment's own guard of the sweep's record, every stored_bytes the scheme's param_bytes;
    the manifest's verified CosSim finite, each stored_param_bytes its file's packed arrays' bytes; the
    compressed fit_results.json re-priced."""
    from nerf_attention_tpu_torch.io import checkpoint
    from nerf_attention_tpu_torch.ops.quantize import param_bytes

    records = data["quantized_params/quantization_results.json"]
    assert len(records) == N_FITS * len(QUANT_SCHEMES), len(records)
    assert list(dict.fromkeys(r["scheme"] for r in records)) == list(QUANT_SCHEMES)
    sweep = {r["name"]: r for r in data["fits/fit_results.json"]}
    params = {f.stem[: -len("_model")]: checkpoint.load_siren_checkpoint(f)["params"]
              for f in checkpoint.checkpoint_glob(root / "fits")}
    worst_guard = 0.0
    for r in records:
        assert math.isfinite(r["final_cosine_mean"]) and math.isfinite(r["final_cosine_min"]), r
        base = r["scheme"][: -len("_qat")] if r["scheme"].endswith("_qat") else r["scheme"]
        assert r["stored_bytes"] == param_bytes(params[r["name"]], base), r
        if r["scheme"] == "fp32":
            worst_guard = max(worst_guard, abs(r["final_cosine_mean"] - sweep[r["name"]]["final_cosine_mean"]))
        if r["scheme"].endswith("_qat"):
            assert r["qat_epochs"] == QAT_EPOCHS, r
    print(f"  quantize: {len(records)} records ({N_FITS} checkpoints x {len(QUANT_SCHEMES)} schemes), finite, "
          f"stored_bytes = param_bytes; fp32 rows within {worst_guard:.2e} of the sweep's CosSim (guard "
          f"{FP32_GUARD})")
    assert worst_guard <= FP32_GUARD, worst_guard
    for scheme in QUANT_SCHEMES:
        rows = [r for r in records if r["scheme"] == scheme]
        print(f"    {scheme:>16}: CosSim {np.mean([r['final_cosine_mean'] for r in rows]):.4f} (min "
              f"{min(r['final_cosine_min'] for r in rows):.4f}) at {np.mean([r['compression_ratio'] for r in rows]):.3f}x, "
              f"{rows[0]['stored_bytes']} bytes a net")

    compressed = root / f"fits_{STUDY_COMPRESS}"
    manifest = data[f"fits_{STUDY_COMPRESS}/compress_manifest.json"]
    assert manifest["scheme"] == STUDY_COMPRESS[: -len("_qat")] and manifest["qat"] is True, manifest["scheme"]
    assert len(manifest["checkpoints"]) == N_FITS and math.isfinite(manifest["verified_cosine_mean"])
    for rec in manifest["checkpoints"]:
        with np.load(compressed / rec["file"]) as arrays:
            packed = sum(arrays[k].nbytes for k in arrays.files if k not in ("__meta__", "target_mean", "target_std"))
        assert rec["stored_param_bytes"] == packed, (rec, packed)
        assert math.isfinite(rec["verified_cosine_mean"]), rec
    print(f"  compress ({STUDY_COMPRESS}): {len(manifest['checkpoints'])} files, params "
          f"{manifest['total_fp32_param_bytes']} -> {manifest['total_stored_param_bytes']} bytes "
          f"({manifest['param_compression_vs_fp32']}x), each stored_param_bytes its file's packed arrays' bytes; "
          f"verified CosSim {manifest['verified_cosine_mean']:.4f} (the sweep's medium nets in fp32: "
          f"{np.mean([r['final_cosine_mean'] for r in records if r['scheme'] == 'fp32']):.4f})")
    by_file = {rec["name"][: -len("_model")]: rec for rec in manifest["checkpoints"]}
    repriced = data[f"fits_{STUDY_COMPRESS}/fit_results.json"]
    assert sorted(r["name"] for r in repriced) == sorted(by_file)
    for r in repriced:
        rec = by_file[r["name"]]
        assert r["storage_scheme"] == manifest["scheme"] and r["qat"] is True
        assert r["siren_size_bytes"] == rec["stored_param_bytes"]
        assert r["compression_ratio"] == r["raw_size_bytes"] / rec["stored_param_bytes"]
        assert r["final_cosine_mean"] == rec["verified_cosine_mean"]
    print(f"  {len(repriced)} fit_results.json records re-priced at the stored bytes, with the verified quality")


def check_incremental(root: Path, coords: str, warm_starts: list, stale: list) -> dict:
    """One convention's incremental_results.json: finite numbers, 8 growth steps, and each warm fit's first
    trajectory point (the CosSim of the forward its first step used) equal to the stale check of the same
    nets (max abs diff 0: one 2C launch on the same params and normalization)."""
    results = json.loads((root / "incremental_results.json").read_text())
    for where, number in walk_numbers(results):
        assert math.isfinite(number), (where, number)
    growth = [s for s in results["steps"] if s["role"] == "growth step"]
    assert results["coords"] == coords and len(results["steps"]) == INCR_SNAPSHOTS and len(growth) == 8, results
    assert results["n_tensors"] == 4 and results["layer"] == 8
    assert len(warm_starts) == len(stale) == len(growth)
    diff = max(float(np.max(np.abs(w - s))) for w, s in zip(warm_starts, stale))
    print(f"  {coords}: warm traj[0] against the stale CosSim, per net, {len(growth)} growth steps: max_abs_diff="
          f"{diff:.3e} (must be 0)")
    assert diff == 0.0, diff
    for step in results["steps"]:
        print(f"    S={step['seq_len']}: scratch {step['scratch_final_cosine']:.4f}"
              + ("" if step["role"] == "initial fit" else
                 f", stale {step['stale_cosine']:.4f}, warm {step['warm_final_cosine']:.4f}, parity at "
                 f"{step['epochs_to_parity']} epochs"))
    print(f"  {coords}: {results['total_warm_epochs_to_parity']} warm epochs against {results['total_scratch_epochs']} "
          f"from scratch (x{results['sustain_speedup_vs_scratch']}), {results['steps_reaching_parity']}/8 steps "
          f"reached parity; the experiment's own wall {results['wall_seconds']:.1f}s")
    return results


def walk_numbers(value, path: str = ""):
    """(path, number) of every int and float in a JSON value."""
    if isinstance(value, dict):
        for k, v in value.items():
            yield from walk_numbers(v, f"{path}.{k}")
    elif isinstance(value, list):
        for i, v in enumerate(value):
            yield from walk_numbers(v, f"{path}[{i}]")
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        yield path, value


def check_study(root: Path, stage_seconds: dict, tmp: Path) -> None:
    """What the study wrote: every JSON artifact of the JAX study's path with
    its keys and finite numbers; the sweep's and the latency check's assertions
    of the earlier phases 4 and 5; the card's analysis and SVD records against
    the port's own on the CPU; the figures not drawn; the aggregate record."""
    from nerf_attention_tpu_torch.analyze import analyze_kv_cache
    from nerf_attention_tpu_torch.experiments.svd import run_svd_experiment
    from nerf_attention_tpu_torch.fit import kv_cosine_means
    from nerf_attention_tpu_torch.utils import plotting

    not_drawn = collections.Counter(plotting.not_drawn)  # before this function's own CPU analysis adds to it
    written = sorted(str(p.relative_to(root)) for p in root.rglob("*.json"))
    assert written == sorted(STUDY_JSON), sorted(set(written) ^ set(STUDY_JSON))
    data = {}
    for rel, (kind, keys) in STUDY_JSON.items():
        value = data[rel] = json.loads((root / rel).read_text())
        items = [value] if kind == "object" else value if kind == "records" else list(value.values())
        assert items, rel
        allowed = keys if isinstance(keys[0], tuple) else (keys,)  # a file whose records take one of several forms
        for item in items:
            assert tuple(item) in allowed, (rel, tuple(item), allowed)
        for where, number in walk_numbers(value, rel):
            assert math.isfinite(number), (where, number)
    print(f"  {len(written)} JSON artifacts, each with the JAX study's keys and finite numbers")

    # The sweep (the earlier phase 4) and the latency check (phase 5).
    results = data["fits/fit_results.json"]
    assert len(results) == 7 * N_FITS, len(results)  # 7 configs x 5 layers x 4 heads x K/V
    assert set(data["fits/sweep_meta.json"]["impl"].values()) == {"cuda"}, data["fits/sweep_meta.json"]["impl"]
    assert len(list((root / "fits").glob("*_medium_model.npz"))) == N_FITS
    for config in sorted({r["config_name"] for r in results}):
        recs = [r for r in results if r["config_name"] == config]
        print(f"  group {config:<7} {sum(r['train_time_seconds'] for r in recs):7.2f}s ({len(recs)} fits)")
    k_cos, v_cos = kv_cosine_means(results)
    print(f"  {len(results)} fits in the fit stage's {stage_seconds['fit']:.2f}s = "
          f"{len(results) / stage_seconds['fit']:.3f} fits/s; mean CosSim K {k_cos:.4f} / V {v_cos:.4f}")
    latency = data["figures/latency_results.json"]
    assert len(latency) == 8 and all(r["hbm_backend"] == "cuda" for r in latency)
    print("  profile_latency, 8 medium checkpoints: 2B exact " + ", ".join(f"{r['siren_time_ms']:.4f}" for r in latency)
          + f" ms against a measured slice read of {latency[0]['hbm_time_measured_ms']:.5f} ms")

    scaling = data["scaling/scaling_results.json"]
    assert [int(s) for s in scaling] == list(SCALING_LADDER)
    for s, rec in scaling.items():
        assert rec["num_experiments"] == 2 * len({0, NUM_LAYERS // 2, NUM_LAYERS - 1})  # head 0's K and V
        assert rec["siren_time_ms"] > 0 and rec["hbm_measured_ms"] > 0
        print(f"  scaling S={s}: CosSim K {rec['avg_cossim_keys']:.4f} / V {rec['avg_cossim_values']:.4f}, decode "
              f"{rec['siren_time_ms']:.4f} ms against a read of {rec['hbm_measured_ms']:.6f} ms")
    crossover = data["figures/crossover_data.json"]
    print(f"  crossover: {crossover['siren_scaling']}, decode/read (measured) {crossover['latency_ratio_range_measured']}")
    assert list(data["multi_prompt/multi_prompt_results.json"]) == list(PROMPTS)
    assert len(data["svd/svd_results.json"]) == len({0, NUM_LAYERS // 2, NUM_LAYERS - 1}) * 4 * 2 * 4
    assert len(data["layer_profile/full_layer_profile.json"]) == 2 * NUM_LAYERS

    # The card's analysis and SVD against the port's own on the CPU, on the same cache.
    cpu = analyze_kv_cache(root / "kv_cache", tmp / "analysis_cpu", verbose=False, device="cpu")
    card = data["analysis/analysis_results.json"]["layer_summaries"]
    worst = {"autocorr/spectral": 0.0, "rank ratio": 0.0}
    for got, want in zip(card, cpu.layer_summaries):
        assert got["layer"] == want.layer
        for key in ("avg_autocorr_k", "avg_autocorr_v", "avg_energy_10pct_k", "avg_energy_10pct_v"):
            worst["autocorr/spectral"] = max(worst["autocorr/spectral"], abs(got[key] - getattr(want, key)))
        for key in ("avg_rank_ratio_k", "avg_rank_ratio_v"):
            worst["rank ratio"] = max(worst["rank ratio"], abs(got[key] - getattr(want, key)))
    print(f"  analysis on the card against the CPU's, {len(card)} layers: max |diff| {worst} "
          f"(limits {STUDY_ATOL}, {RANK_RATIO_ATOL:.2e})")
    assert worst["autocorr/spectral"] <= STUDY_ATOL and worst["rank ratio"] <= RANK_RATIO_ATOL, worst
    svd_cpu = run_svd_experiment(root / "kv_cache", tmp / "svd_cpu", verbose=False, device="cpu")
    gaps = {"final_cosine_mean": 0.0, "final_cosine_min": 0.0, "final_cosine_std": 0.0}
    for got, want in zip(data["svd/svd_results.json"], svd_cpu):
        assert {k: v for k, v in got.items() if k not in gaps} == {k: v for k, v in want.items() if k not in gaps}
        for key in gaps:
            gaps[key] = max(gaps[key], abs(got[key] - want[key]))
    print(f"  SVD records on the card against the CPU's ({len(svd_cpu)}): max |diff| "
          + ", ".join(f"{k[6:]} {v:.3e}" for k, v in gaps.items())
          + f" (limits {STUDY_ATOL} for the mean, {SVD_ROW_STAT_ATOL} for the rows' min and std)")
    assert gaps["final_cosine_mean"] <= STUDY_ATOL, gaps
    assert gaps["final_cosine_min"] <= SVD_ROW_STAT_ATOL and gaps["final_cosine_std"] <= SVD_ROW_STAT_ATOL, gaps

    aggregate = data["aggregate_decode/aggregate_decode.json"]
    assert aggregate["num_networks"] == NUM_LAYERS * NUM_HEADS * 2 and aggregate["backend"] == "cuda"
    print(f"  aggregate decode, {aggregate['num_networks']} medium nets at S={aggregate['seq_len']} "
          f"({aggregate['weights_source']}): 2C fp32 {aggregate['siren_aggregate_ms']:.4f} ms, bf16 "
          f"{aggregate['siren_aggregate_bf16_ms']:.4f} ms, fast sine {aggregate['siren_aggregate_fastsin_ms']:.4f} ms; "
          f"the measured stream read of the {aggregate['cache_bytes_bf16']} bf16 bytes "
          f"{aggregate['hbm_measured_aggregate_ms']:.4f} ms (x{aggregate['ratio_vs_measured']:.1f} / "
          f"x{aggregate['ratio_bf16_vs_measured']:.1f} / x{aggregate['ratio_fastsin_vs_measured']:.1f}), one slice's "
          f"read x{aggregate['num_networks']} {aggregate['hbm_slice_extrapolated_ms']:.4f} ms")
    check_quantized(root, data)
    check_attention_error(data["attention_error/attention_error_results.json"], ())
    check_head_policy(data["head_policy/head_policy_results.json"], HP_LAYERS, HP_KV, HP_PAYLOADS)
    for name in ("serve_plan.json", "serve_plan_tiered.json"):
        plan = data[name]
        assert plan["n_units"] == HP_LAYERS * HP_KV == len(plan["plan"]) and 0 <= plan["n_served"] <= plan["n_units"]
        schemes = sorted({r.get("scheme", r.get("bytes_scheme")) for r in plan["plan"] if r["serve"]})
        print(f"  {name}: {plan['n_served']}/{plan['n_units']} units served at cost target {plan['cost_target']} "
              f"(predicted {plan['predicted_cost_at_cut']:.2e}), net bytes saved {plan['net_bytes_saved']}, "
              f"schemes {schemes}")
    print("  figures not drawn (no matplotlib): "
          + (", ".join(f"{name} x{count}" for name, count in not_drawn.items()) or "none"))
    print("  stage seconds: " + ", ".join(f"{stage} {sec:.1f}" for stage, sec in stage_seconds.items()))


def check_attention_error(attn: dict, schemes) -> None:
    """The attention end-metric's JSON at experiments attention_error's defaults: the probed layers, heads, queries
    and gains, every variant's output cosines in [-1, 1], the stored payloads' blocks; one line per layer."""
    assert [r["layer"] for r in attn["layers"]] == list(ATTN_LAYERS), attn["layers"]
    assert (attn["config"], attn["seq_len"], attn["n_queries"], attn["gains"], attn["schemes"]) == (
        "medium", SEQ_LEN, ATTN_QUERIES, list(ATTN_GAINS), list(schemes))
    regimes = {"diffuse", *(f"matched_g{g:g}" for g in ATTN_GAINS)}
    sharpest = f"matched_g{max(ATTN_GAINS):g}"
    for row in attn["layers"]:
        assert row["heads"] == ATTN_HEADS and list(row.get("storage", {})) == list(schemes)
        blocks = [row] + [row["storage"][scheme] for scheme in schemes]
        for block in blocks:
            assert set(block["regimes"]) == regimes
            for regime in block["regimes"].values():
                for m in regime["variants"].values():
                    assert -1.0 <= m["output_cosine_min"] <= m["output_cosine_mean"] + 1e-6 <= 1.0 + 1e-6, m
                    assert 0.0 <= m["top1_agreement"] <= 1.0 and 0.0 <= m["attn_tv_mean"] <= 1.0 + 1e-6, m
        peak, broad = row["regimes"][sharpest], row["regimes"]["diffuse"]
        print(f"    L{row['layer']}: fit K {row['key_fit_cosine']:.4f} / V {row['value_fit_cosine']:.4f}; full swap "
              f"{peak['variants']['full']['output_cosine_mean']:.4f} @ {peak['exact_entropy_nats']:.2f} nats "
              f"({sharpest}), {broad['variants']['full']['output_cosine_mean']:.4f} @ "
              f"{broad['exact_entropy_nats']:.2f} nats (diffuse)"
              + "".join(f"; stored {scheme}: proxy K {row['storage'][scheme]['key_proxy_cosine']:.4f} / V "
                        f"{row['storage'][scheme]['value_proxy_cosine']:.4f}, full swap "
                        f"{row['storage'][scheme]['regimes'][sharpest]['variants']['full']['output_cosine_mean']:.4f}"
                        for scheme in schemes))
    print(f"  attention end-metric: {len(attn['layers'])} layers x {ATTN_HEADS} heads, {attn['n_queries']} queries at "
          f"S={attn['seq_len']}, {attn['config']} x {attn['epochs']} epochs, {attn['wall_seconds']:.1f}s")


def check_head_policy(hp: dict, n_layers: int, n_kv: int, payloads, moe: bool = False) -> None:
    """The head-policy study's JSON: its units and payloads, every curve's budget-0 cosine within 1e-6 of 1 (the
    true cache), the full-budget cosine equal across policies (one mask), finite laws, the MoE leg's flip rates
    in [0, 1] where ``moe``; one summary line."""
    assert len(hp["units"]) == n_layers * n_kv and list(hp["payloads"]) == list(payloads), list(hp["payloads"])
    assert (hp["moe_routing"] is not None) == moe and hp["model"]["num_hidden_layers"] == n_layers
    for key in ("entropy_law_solo", "entropy_law_solo_2factor", "entropy_law_solo_cache", "entropy_law_solo_sink3"):
        assert all(math.isfinite(v) for v in (hp[key] or {}).values()), (key, hp[key])
    if moe:
        for order in hp["moe_routing"]["orders"].values():
            assert all(0.0 <= f <= 1.0 for f in order["flip_rate"]), order["flip_rate"]
    full = {}
    for scheme, payload in hp["payloads"].items():
        ends = {name: curve["output_cosine"][-1] for name, curve in payload["policies"].items()}
        for name, curve in payload["policies"].items():
            assert abs(curve["output_cosine"][0] - 1.0) <= 1e-6, (scheme, name, curve["output_cosine"][0])
        assert len(set(ends.values())) == 1, (scheme, ends)
        full[scheme] = ends["law"]
    ent = [u["entropy_nats"] for u in hp["units"]]
    cost = [u["solo_cost"] for u in hp["units"]]
    law = hp["entropy_law_solo"] or {}
    print(f"  head policy: {n_layers} layers x {n_kv} KV heads, S={hp['model']['seq_len']}, {hp['net']} x "
          f"{hp['epochs']} epochs: entropy {min(ent):.2f}-{max(ent):.2f} nats, solo cost {min(cost):.2e}-"
          f"{max(cost):.2e}; full swap " + ", ".join(f"{k} {v:.5f}" for k, v in full.items())
          + (f"; law slope {law['slope']:.3f}, R^2 {law['r2']:.3f}" if law else "; law not fitted")
          + f"; {hp['wall_seconds']:.1f}s")


def json_gaps(got, want, path: str = "", gaps: dict | None = None) -> dict:
    """The largest |got - want| per leaf name of two JSON values of one structure (wall_seconds left out)."""
    gaps = {} if gaps is None else gaps
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k, v in want.items():
            if k != "wall_seconds":
                json_gaps(got[k], v, k, gaps)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for g, w in zip(got, want):
            json_gaps(g, w, path, gaps)
    elif isinstance(want, float):
        gaps[path] = max(gaps.get(path, 0.0), abs(got - want))
    else:
        assert got == want, (path, got, want)
    return gaps


def card_against_cpu(kv_dir: Path, tmp: Path) -> None:
    """Phase 19: the attention end-metric (one layer, S=2048) and a tiny head-policy study on the card and on the
    CPU. Both draw their initial params (init_siren, torch.Generator(seed) on the host) and queries (make_queries)
    from the same seeds on the host, so the two runs start from the same numbers."""
    import torch

    from nerf_attention_tpu_torch.experiments import attention_error, head_policy

    def held(what: str, gaps: dict, tol_of) -> None:
        worst = {}
        for name, gap in gaps.items():
            tol = tol_of(name)
            worst[tol] = max(worst.get(tol, (0.0, "")), (gap, name))
        print(f"  {what}, card against CPU: max |diff| by limit " + ", ".join(
            f"{gap:.3e} ({name}; limit {tol:g})" for tol, (gap, name) in sorted(worst.items())))
        over = {name: gap for name, gap in gaps.items() if gap > tol_of(name)}
        assert not over, (what, over)

    runs, took = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[device] = attention_error.run_attention_error_experiment(kv_dir, tmp / f"card_cpu_{device}",
                                                                      device=device, **CARD_CPU_ATTN)
        torch.cuda.synchronize()
        took[device] = time.perf_counter() - t0
    print(f"  attention end-metric, layer {CARD_CPU_ATTN['layers'][0]}, {ATTN_HEADS} heads, S={SEQ_LEN}, medium x "
          f"{CARD_CPU_ATTN['epochs']} epochs: card {took['cuda']:.1f}s, CPU {took['cpu']:.1f}s")
    held("attention end-metric", json_gaps(runs["cuda"], runs["cpu"]),
         lambda name: {"exact_entropy_nats": CARD_CPU_TOL["entropy"], "top1_agreement": CARD_CPU_TOL["top1"]}.get(
             name, CARD_CPU_TOL["fit"]))
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[device] = head_policy.run_head_policy_experiment(tmp / f"hp_card_cpu_{device}", device=device,
                                                              **CARD_CPU_HP)
        took[device] = time.perf_counter() - t0
    print(f"  head policy (S={CARD_CPU_HP['seq_len']}, {CARD_CPU_HP['num_layers']} layers, tiny x "
          f"{CARD_CPU_HP['epochs']} epochs): card {took['cuda']:.1f}s, CPU {took['cpu']:.1f}s")
    held("head policy", json_gaps(runs["cuda"], runs["cpu"]),
         lambda name: CARD_CPU_TOL["entropy"] if name == "entropy_nats" else CARD_CPU_TOL["law"]
         if name in LAW_FIELDS else CARD_CPU_TOL["fit"])


def serving_at_8b_widths(study_kv: Path, tmp: Path) -> None:
    """Phase 20: the head-policy study and measure_entropy at Llama-3.1-8B's attention widths, measure_entropy on
    the MLA toy model, and extract --synthetic against phase 4's cache; each with its seconds and peak memory."""
    import torch

    from nerf_attention_tpu_torch import extract, measure_entropy
    from nerf_attention_tpu_torch.experiments import head_policy

    def timed(what: str, run):
        """Seconds and peak device memory of one run; the peak less what was allocated before it (earlier
        phases' tensors still held) is the run's own."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"  {what}: {time.perf_counter() - t0:.1f}s, peak device memory {peak / 2**30:.2f} GiB, "
              f"{(peak - held) / 2**30:.2f} GiB of it the run's own", flush=True)
        return out

    print(f"  Llama-3.1-8B attention widths: hidden {SERVE_8B['hidden_size']}, {SERVE_8B['num_heads']} query / "
          f"{SERVE_8B['num_kv_heads']} KV heads, head_dim {SERVE_8B['head_dim']}, FFN {SERVE_8B['intermediate_size']}, "
          f"plain RoPE; cuts: {'; '.join(SERVE_8B_CUTS)}")
    hp = timed(f"head policy, {SERVE_8B_LAYERS} layers, S={SERVE_8B_SEQ}, small nets, default scheme",
               lambda: head_policy.run_head_policy_experiment(
                   tmp / "hp_8b", seq_len=SERVE_8B_SEQ, epochs=STUDY_EPOCHS, config_name="small",
                   num_layers=SERVE_8B_LAYERS, verbose=False, **SERVE_8B))
    check_head_policy(hp, SERVE_8B_LAYERS, SERVE_8B["num_kv_heads"], HP_PAYLOADS)
    geometry = ["--layers", str(SERVE_8B_LAYERS), "--heads", str(SERVE_8B["num_heads"]), "--kv_heads",
                str(SERVE_8B["num_kv_heads"]), "--head_dim", str(SERVE_8B["head_dim"]), "--hidden",
                str(SERVE_8B["hidden_size"]), "--intermediate", str(SERVE_8B["intermediate_size"])]
    timed(f"measure_entropy --random_init, same widths and cut, S={ENTROPY_8B_SEQ}",
          lambda: measure_entropy.main(["--random_init", *geometry, "--seq_len", str(ENTROPY_8B_SEQ), "--out",
                                        str(tmp / "entropy_8b.json")]))
    ent = np.asarray(json.loads((tmp / "entropy_8b.json").read_text())["entropy_nats"])
    assert ent.shape == (SERVE_8B_LAYERS, SERVE_8B["num_kv_heads"]) and np.all(np.isfinite(ent))
    assert np.all(ent > 0) and np.all(ent <= np.log(ENTROPY_8B_SEQ) + 1e-4), ent
    timed("measure_entropy --mla_random_init, its defaults",
          lambda: measure_entropy.main(["--mla_random_init", "--out", str(tmp / "entropy_mla.json")]))
    mla = json.loads((tmp / "entropy_mla.json").read_text())
    assert mla["mla_latent"] and len(mla["entropy_nats"]) == 4 and all(math.isfinite(e[0]) for e in mla["entropy_nats"])
    timed(f"extract --synthetic, S={SEQ_LEN}", lambda: extract.main(
        ["--synthetic", "--seq_len", str(SEQ_LEN), "--output_dir", str(tmp / "extract")]))
    files = lambda root: {p.name: p.read_bytes() for p in sorted(root.iterdir())}
    got, want = files(tmp / "extract"), files(study_kv)
    assert list(got) == list(want) and got == want, sorted(set(got) ^ set(want))
    print(f"  extract --synthetic: {len(got)} files equal phase 4's cache byte for byte")


SAFETENSORS_DTYPES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16"}


def write_safetensors(path: Path, tensors: dict) -> int:
    """One .safetensors file (an 8-byte header length, the JSON header padded to 8 bytes, the raw bytes in the
    header's order) of CPU or device tensors; returns the bytes of tensor data."""
    import torch

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype).split(".")[-1]], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for t in tensors.values():
            t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tofile(f)
    return offset


def write_checkpoint(directory: Path, config: dict, tensors: dict, shards: int = 2) -> int:
    """An HF checkpoint directory: config.json, the tensors in ``shards`` files split by byte count, and the
    index naming each tensor's file; returns the bytes of tensor data."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(json.dumps(config))
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    parts, seen = [{} for _ in range(shards)], 0
    for name, t in tensors.items():
        parts[min(shards - 1, seen * shards // max(total, 1))][name] = t
        seen += t.numel() * t.element_size()
    weight_map = {}
    for i, part in enumerate(parts):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        write_safetensors(directory / fname, part)
        weight_map.update(dict.fromkeys(part, fname))
    (directory / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


# Phase 22, the text-in path: Llama-3.1-8B's widths (LLAMA_31_8B, huggingface.co/meta-llama/Llama-3.1-8B config.json)
# written as an HF checkpoint in bf16 beside the committed Llama-3-format tokenizer (tests/data/tokenizer_llama3).
TEXT_CONFIG = {**LLAMA_31_8B, "num_hidden_layers": 8, "architectures": ["LlamaForCausalLM"],
               "torch_dtype": "bfloat16", "bos_token_id": 0, "eos_token_id": 1, "tie_word_embeddings": False}
TEXT_CUTS = ["layers 8 of 32", "vocabulary 4096 of 128256 (the fixture tokenizer's)", f"epochs {STUDY_EPOCHS} of 2000"]
TEXT_TOKENIZER = Path("tests") / "data" / "tokenizer_llama3"
TEXT_FILES = ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json")
TEXT_SEQ = 2048
TEXT_SWEEP_LAYERS = [0, 2, 4, 6, 7]  # the sweep's 5 layers of an 8-layer cache
TEXT_GROUPS = 7  # the sweep's architecture groups, one fit_batch each
TEXT_TIMING = 1 + 5 * 200  # 2B launches of one time_siren_forward_ms on the card: a warm-up, 5 samples of 200


def draw_llama_8b(dev, seed: int = 2, config: dict | None = None) -> dict:
    """``config``'s tensors (TEXT_CONFIG's by default) under their HF names and layouts
    (``LlamaForCausalLM.state_dict()``), bf16, drawn on the card from ``torch.Generator(seed)``: projections
    N(0, 0.02), norms 1 + N(0, 0.1)."""
    import torch

    c = TEXT_CONFIG if config is None else config
    g = torch.Generator(device=dev).manual_seed(seed)
    h, ff = c["hidden_size"], c["intermediate_size"]
    nq, nkv = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]

    def normal(*shape, std=0.02, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * std + mean).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": normal(c["vocab_size"], h)}
    for layer in range(c["num_hidden_layers"]):
        p = f"model.layers.{layer}"
        for name, rows in (("q_proj", nq), ("k_proj", nkv), ("v_proj", nkv)):
            t[f"{p}.self_attn.{name}.weight"] = normal(rows, h)
        t[f"{p}.self_attn.o_proj.weight"] = normal(h, nq)
        t[f"{p}.mlp.gate_proj.weight"] = normal(ff, h)
        t[f"{p}.mlp.up_proj.weight"] = normal(ff, h)
        t[f"{p}.mlp.down_proj.weight"] = normal(h, ff)
        t[f"{p}.input_layernorm.weight"] = normal(h, std=0.1, mean=1.0)
        t[f"{p}.post_attention_layernorm.weight"] = normal(h, std=0.1, mean=1.0)
    t["model.norm.weight"] = normal(h, std=0.1, mean=1.0)
    t["lm_head.weight"] = normal(c["vocab_size"], h)
    return t


@contextlib.contextmanager
def tally(module, name: str, calls: list):
    """``module.name`` replaced, inside the block, by a wrapper that appends (kernel 2A, 2B and 2C launches, the
    call's arguments by name with their defaults, its result) of each call to ``calls``."""
    import inspect

    from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda

    inner = getattr(module, name)
    signature = inspect.signature(inner)

    def now():
        return (siren_train_cuda.launches["siren_train_grads"], siren_cuda.launches["siren_decode"],
                siren_cuda.launches["siren_decode_batch"])

    def wrapper(*args, **kwargs):
        before = now()
        out = inner(*args, **kwargs)
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append((tuple(b - a for a, b in zip(before, now())), bound.arguments, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, inner)


def check_fp64(what: str, got, plain, exact) -> float:
    """Kernel output ``got`` and the plain version's ``plain`` against ``exact``, an fp64 forward of the same
    params: the kernel's largest error at most ``FP64_GAIN`` times the plain version's. Returns the largest
    |got - plain|, the kernels line's measure."""
    import torch

    got, plain = got.reshape(plain.shape), plain
    torch.cuda.synchronize()
    err_kernel = (got.double() - exact).abs().max().item()
    err_plain = (plain.double() - exact).abs().max().item()
    gap = (got - plain).abs().max().item()
    print(f"  {what}: |kernel - fp64| {err_kernel:.3e}, |plain - fp64| {err_plain:.3e} "
          f"({err_kernel / err_plain:.2f}x, at most {FP64_GAIN:g}x), |kernel - plain| {gap:.3e}")
    assert err_kernel <= FP64_GAIN * err_plain, (what, err_kernel, err_plain)
    return gap


def leaf_spans(dims) -> list[tuple[str, int, int]]:
    """(name, first column, end column) of each leaf of a ``SirenStack``'s flat buffer: W0, b0, W1, b1, ..."""
    spans, off = [], 0
    for i, (d_in, d_out) in enumerate(dims):
        spans += [(f"W{i}", off, off + d_in * d_out), (f"b{i}", off + d_in * d_out, off + d_in * d_out + d_out)]
        off += d_in * d_out + d_out
    return spans


def fp64_leaf_errors(grads, plain, exact, dims) -> dict:
    """Per leaf (one W_i or b_i across every net): the kernel's largest error against the fp64 gradients
    ``exact``, the plain version's, and the kernel's limit, ``FM_LEAF_GAIN`` times the larger of the plain
    version's error and ``FM_LEAF_FLOOR`` of the leaf's largest |fp64 gradient|; and that largest gradient."""
    rows = {}
    for name, lo, hi in leaf_spans(dims):
        want = exact[:, lo:hi]
        err_kernel = (grads[:, lo:hi].double() - want).abs().max().item()
        err_plain = (plain[:, lo:hi].double() - want).abs().max().item()
        scale = want.abs().max().item()
        rows[name] = (err_kernel, err_plain, FM_LEAF_GAIN * max(err_plain, FM_LEAF_FLOOR * scale), scale)
    return rows


def check_train_fp64(stack, targets_norm, tag: str, **kw) -> float:
    """Kernel 2A on trained FM nets, whose first-layer arguments (omega x up to 64) leave the fp32 plain version's
    gradients inexact. The loss against the plain version (``TRAIN_TOL["fm"]``); the gradients element by element
    against the plain version (``FM_GRAD_TOL``); and leaf by leaf, the kernel's and the plain version's gradients
    each against a float64 autograd of the same function on the same params, the kernel's error within its
    ``fp64_leaf_errors`` limit. A planted fault, the kernel's output-layer gradients zeroed, must fail that
    leaf check. Returns the largest |kernel - plain|, the kernels line's measure."""
    import torch

    from nerf_attention_tpu_torch.models.siren import SirenStack, positions, siren_apply_maybe_fm
    from nerf_attention_tpu_torch.ops import siren_train_cuda
    from nerf_attention_tpu_torch.ops.fastmath import resolve_sin

    loss, grads = siren_train_cuda.siren_train_grads(stack, targets_norm, **kw)
    p_loss, p_grads = siren_train_cuda.siren_train_grads_plain(stack, targets_norm, **kw)
    torch.cuda.synchronize()
    gap = check_close(f"{tag} loss", loss, p_loss, **TRAIN_TOL["fm"]["loss"])
    with torch.enable_grad():
        flat = stack.flat.double().requires_grad_(True)
        x = positions(targets_norm.shape[1], total_len=kw.get("total_len"), device=flat.device).double()
        pred = siren_apply_maybe_fm(SirenStack(flat, stack.dims).params(), kw["omega"], kw.get("fm_mult"), x,
                                    sin=resolve_sin(kw.get("sin_impl", "exact")))
        (exact,) = torch.autograd.grad(((pred - targets_norm.double()) ** 2).mean(dim=(1, 2)).sum(), flat)
    rows = fp64_leaf_errors(grads.flat, p_grads.flat, exact, stack.dims)
    print(f"  {tag} grads against fp64, |kernel - fp64| / |plain - fp64| / largest |fp64| (share of the kernel's "
          "limit): " + ", ".join(f"{name} {k:.2e}/{p:.2e}/{m:.1e} ({k / limit:.2f})"
                                 for name, (k, p, limit, m) in rows.items()))
    gap = max(gap, check_close(f"{tag} grads", grads.flat, p_grads.flat, **FM_GRAD_TOL))
    over = {name: row for name, row in rows.items() if row[0] > row[2]}
    assert not over, (tag, over)
    planted = grads.flat.clone()
    out_w, out_b = leaf_spans(stack.dims)[-2:]
    planted[:, out_w[1]:out_b[2]] = 0
    caught = {name: k / limit for name, (k, _, limit, _) in fp64_leaf_errors(planted, p_grads.flat, exact,
                                                                              stack.dims).items() if k > limit}
    print(f"  {tag} planted fault (output layer's gradients zeroed): caught at "
          + ", ".join(f"{name} ({share:.1f}x its limit)" for name, share in caught.items()))
    assert {out_w[0], out_b[0]} <= set(caught), (tag, caught)
    return gap


def hold_fits(stage: str, fits: list, dev, check_train, err: dict) -> None:
    """Phase 22: at each fit_batch's own shape (its targets' N, S and D, its net, sine and fm_mult) and fitted
    params, one 2A step against its plain version (``TRAIN_TOL``; an FM fit's, each against an fp64 autograd,
    ``check_train_fp64``); the final evaluation's 2C decode (exact sine)
    and 2B on the first net with both sines (the timed decodes and the per-position curves), each with its plain
    version against an fp64 forward (``check_fp64``). ``fits`` as ``tally`` records ``fit_batch_dispatch``; each
    kernel's largest error against its plain version goes into ``err``."""
    import torch

    from nerf_attention_tpu_torch.models.siren import SirenStack, positions, siren_apply_maybe_fm
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops.fastmath import resolve_sin
    from nerf_attention_tpu_torch.parallel.sweep import normalize_targets

    def fp64(stack, omega, s, fm, sine):
        params = [(w.double(), b.double()) for w, b in stack.params()]
        x = positions(s, device=stack.flat.device).double()
        return siren_apply_maybe_fm(params, omega, fm, x, sin=resolve_sin(sine))

    with uncounted():
        for _, call, (n, stack, _) in fits:
            config, fm, sin_impl = call["config"], call["fm_mult"], call["sin_impl"]
            targets = torch.as_tensor(call["targets"], dtype=torch.float32, device=dev)
            s, omega = targets.shape[1], config.omega_0
            tag = f"{stage} {config.name} N={n} S={s} fm={fm}"
            targets_norm = normalize_targets(targets)[0].contiguous()
            step = (check_train_fp64(stack, targets_norm, f"siren_train_grads {tag} {sin_impl}", omega=omega,
                                     sin_impl=sin_impl, fm_mult=fm) if fm else
                    check_train(stack, targets_norm, f"siren_train_grads {tag} {sin_impl}", TRAIN_TOL[sin_impl],
                                omega=omega, sin_impl=sin_impl))
            err["siren_train_grads"] = max(err["siren_train_grads"], step)
            err["siren_decode_batch"] = max(err["siren_decode_batch"], check_fp64(
                f"siren_decode_batch {tag} exact", siren_cuda.siren_decode_batch(stack, omega, s, fm_mult=fm),
                siren_cuda.siren_decode_plain(stack, omega, s, fm_mult=fm), fp64(stack, omega, s, fm, "exact")))
            first = SirenStack.from_params([(w[:1], b[:1]) for w, b in stack.params()])
            for sine in ("exact", "fast"):
                err["siren_decode"] = max(err["siren_decode"], check_fp64(
                    f"siren_decode {tag} {sine}", siren_cuda.siren_decode(first, omega, s, sin_impl=sine, fm_mult=fm),
                    siren_cuda.siren_decode_plain(first, omega, s, sin_impl=sine, fm_mult=fm),
                    fp64(first, omega, s, fm, sine)))
    if not fits:
        return
    shapes = sorted({(call["config"].name, out[0], np.shape(call["targets"])[1]) for _, call, out in fits})
    print(f"  stage {stage}: 2A, 2C and 2B held at {len(fits)} fits' shapes {shapes}")


def text_path_at_8b_width(dev, tmp: Path, experiments_cli, check_train) -> tuple[dict, dict]:
    """Phase 22: the text-in path on a checkpoint at Llama-3.1-8B's widths (8 layers, bf16) beside the committed
    Llama-3-format tokenizer: the port's ids against the committed AutoTokenizer ids; extract --backend jax and hf,
    each cache equal to llama_prefill_kv on those ids bit for bit; the study on it (extract, analysis, the sweep,
    evaluate) and the scaling and multi-prompt experiments through --backend jax, exact 2A / 2B / 2C launches a
    stage and one checkpoint load each; measure_entropy --model; then a 2-layer DeepSeek-V2-Lite with the same
    tokenizer through extract --backend jax and measure_entropy --model. 2A, 2B and 2C are held to their plain
    versions at every fit's shape, outside the counts. Returns the launches of 2A, 2B and 2C, and the largest
    error of each against its plain version."""
    import shutil

    import torch

    from nerf_attention_tpu_torch import evaluate, extract, measure_entropy, study
    from nerf_attention_tpu_torch.extract import get_sample_text
    from nerf_attention_tpu_torch.io import kvstore
    from nerf_attention_tpu_torch.io.tokenizer import load_tokenizer
    from nerf_attention_tpu_torch.models import llama, mla
    from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda
    from nerf_attention_tpu_torch.parallel import sweep
    from nerf_attention_tpu_torch.utils import timing

    repo = Path(__file__).resolve().parent
    seconds = {}

    def timed(what: str, run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds[what] = time.perf_counter() - t0
        print(f"  {what}: {seconds[what]:.2f}s", flush=True)
        return out

    loads = []  # (loader, seconds) of every checkpoint read

    @contextlib.contextmanager
    def counting_loads():
        patched = [(m, n) for m in (llama, extract, measure_entropy) for n in ("load_llama_params",) if hasattr(m, n)]
        patched += [(m, n) for m in (mla, extract, measure_entropy) for n in ("load_mla_params",) if hasattr(m, n)]
        originals = {(m, n): getattr(m, n) for m, n in patched}

        def wrap(fn, name):
            def load(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                loads.append((name, time.perf_counter() - t0))
                print(f"  checkpoint read by {name}: {loads[-1][1]:.2f}s", flush=True)
                return out
            return load

        for (m, n), fn in originals.items():
            setattr(m, n, wrap(fn, n))
        try:
            yield
        finally:
            for (m, n), fn in originals.items():
                setattr(m, n, fn)

    err = {"siren_train_grads": 0.0, "siren_decode": 0.0, "siren_decode_batch": 0.0}

    def launches():
        return {"siren_train_grads": siren_train_cuda.launches["siren_train_grads"],
                "siren_decode": siren_cuda.launches["siren_decode"],
                "siren_decode_batch": siren_cuda.launches["siren_decode_batch"]}

    start_counts = launches()
    print(f"  Llama-3.1-8B widths: hidden {TEXT_CONFIG['hidden_size']}, {TEXT_CONFIG['num_attention_heads']} query / "
          f"{TEXT_CONFIG['num_key_value_heads']} KV heads of {TEXT_CONFIG['head_dim']}, FFN "
          f"{TEXT_CONFIG['intermediate_size']}, rope_theta {TEXT_CONFIG['rope_theta']:g} with llama3 scaling, bf16; "
          f"cuts: {'; '.join(TEXT_CUTS)}")
    ckpt = tmp / "llama_8b_text"
    drawn = draw_llama_8b(dev)
    nbytes = timed("write (drawn on the card, two HF-named bf16 shards)", lambda: write_checkpoint(ckpt, TEXT_CONFIG,
                                                                                                   drawn))
    del drawn
    for name in TEXT_FILES:
        shutil.copy(repo / TEXT_TOKENIZER / name, ckpt / name)
    print(f"  {nbytes / 1e9:.3f} GB of tensors under {ckpt.name}, the tokenizer copied from {TEXT_TOKENIZER}")

    # Tokenize: the port's reader against the ids AutoTokenizer gave for the committed fixture.
    expected = json.loads((repo / TEXT_TOKENIZER / "expected_ids.json").read_text(encoding="utf-8"))
    tok = timed("tokenizer load (tokenizer.json, tokenizer_config.json)", lambda: load_tokenizer(ckpt))
    for text, ids in zip(expected["strings"], expected["ids"]):
        assert tok(text)["input_ids"] == ids, repr(text)
    ids = timed(f"tokenize the sample text at max_length={TEXT_SEQ}",
                lambda: tok(get_sample_text(), truncation=True, max_length=TEXT_SEQ)["input_ids"])
    assert ids == expected["sample_text_2048"][:TEXT_SEQ], "the sample text's ids"
    print(f"  ids equal AutoTokenizer's on {len(expected['strings'])} strings and the sample text ({len(ids)} ids)")

    # Extract through both backends; each cache equals the prefill on those ids bit for bit.
    with counting_loads():
        config, params = llama.load_llama_params(ckpt, dtype=torch.bfloat16, device=dev)
        keys, values = timed(f"prefill, S={len(ids)} (llama_prefill_kv)", lambda: llama.llama_prefill_kv(config,
                                                                                                         params, ids))
        timed("the same prefill again (warm)", lambda: llama.llama_prefill_kv(config, params, ids))
        want_k, want_v = keys.float().cpu().numpy(), values.float().cpu().numpy()
        del params, keys, values
        torch.cuda.empty_cache()
        for backend in ("jax", "hf"):
            out = tmp / f"text_extract_{backend}"
            timed(f"extract --backend {backend}", lambda: extract.main(
                ["--backend", backend, "--model", str(ckpt), "--seq_len", str(TEXT_SEQ), "--output_dir", str(out)]))
            meta = kvstore.load_metadata(out)
            assert (meta.num_layers, meta.num_kv_heads, meta.head_dim, meta.seq_len, meta.actual_tokens) == (
                TEXT_CONFIG["num_hidden_layers"], TEXT_CONFIG["num_key_value_heads"], TEXT_CONFIG["head_dim"],
                len(ids), len(ids)), meta
            for i in range(meta.num_layers):
                k, v = kvstore.load_layer(out, i)
                assert np.array_equal(k, want_k[i]) and np.array_equal(v, want_v[i]), (backend, i)
            print(f"  extract --backend {backend}: metadata {meta.to_dict()}; every layer's K and V equal "
                  "llama_prefill_kv's bit for bit")
    assert [name for name, _ in loads] == ["load_llama_params"] * 3, loads
    del want_k, want_v

    # The study on the checkpoint, stage by stage, and the two experiments through the jax backend.
    root = tmp / "text_study"
    base = ["--backend", "jax", "--model", str(ckpt), "--root", str(root), "--epochs", str(STUDY_EPOCHS),
            "--seq_len", str(TEXT_SEQ)]
    exp_base = ["--backend", "jax", "--model", str(ckpt), "--results_root", str(root), "--kv_dir",
                str(root / "kv_cache"), "--siren_dir", str(root / "fits"), "--epochs", str(STUDY_EPOCHS)]
    stages = {
        "extract": lambda: study.main([*base, "--skip", "fit", "evaluate", "experiments"]),
        "fit": lambda: study.main([*base, "--skip", "extract", "evaluate", "experiments"]),
        "evaluate": lambda: study.main([*base, "--skip", "extract", "fit", "experiments"]),
        "scaling": lambda: experiments_cli.main(["scaling", *exp_base, "--seq_lengths",
                                                 *map(str, SCALING_LADDER)]),
        "multi_prompt": lambda: experiments_cli.main(["multi_prompt", *exp_base, "--seq_len", str(TEXT_SEQ)]),
    }
    stage_launches = {}
    for stage, run in stages.items():
        fits, timings, curves, before, n_loads = [], [], [], launches(), len(loads)
        with counting_loads(), tally(sweep, "fit_batch_dispatch", fits), tally(timing, "per_launch_ms", timings), \
                tally(evaluate, "per_position_cosines", curves):
            timed(f"study stage {stage}", run)
        got = {k: v - before[k] for k, v in launches().items()}
        stage_launches[stage] = got
        stage_loads = [name for name, _ in loads[n_loads:]]
        # Every launch of the stage is explained: epochs of 2A and one 2C (the final evaluation) a fit_batch;
        # 1 + samples x reps of 2B a timed decode; one 2B a per-position curve.
        for (a, b, c), _, _ in fits:
            assert (a, b, c) == (STUDY_EPOCHS, 0, 1), (stage, a, b, c)
        decode_timings = [(a, b, c) for (a, b, c), _, _ in timings if b]
        assert all(t == (0, TEXT_TIMING, 0) for t in decode_timings), (stage, decode_timings)
        n_curves = sum(len(out) for _, _, out in curves)
        assert got == {"siren_train_grads": STUDY_EPOCHS * len(fits),
                       "siren_decode": TEXT_TIMING * len(decode_timings) + n_curves,
                       "siren_decode_batch": len(fits)}, (stage, got)
        want_fits = {"extract": 0, "fit": TEXT_GROUPS, "evaluate": 0, "scaling": len(SCALING_LADDER),
                     "multi_prompt": len(PROMPTS)}[stage]
        want_timed = {"evaluate": 8 * 2, "scaling": 4 * len(SCALING_LADDER)}.get(stage, 0)
        assert (len(fits), len(decode_timings), n_curves) == (want_fits, want_timed, 4 if stage == "evaluate" else 0), (
            stage, len(fits), len(decode_timings), n_curves)
        assert stage_loads == (["load_llama_params"] if stage in ("extract", "scaling", "multi_prompt") else []), (
            stage, stage_loads)
        print(f"  stage {stage}: launches {got} ({len(fits)} fit_batch calls, {len(decode_timings)} timed decodes, "
              f"{n_curves} per-position curves); checkpoint loads {len(stage_loads)}")
        hold_fits(stage, fits, dev, check_train, err)
        del fits

    # What the study wrote: the keys of the JAX study's artifacts and finite numbers.
    meta = kvstore.load_metadata(root / "kv_cache")
    assert meta.model_name == str(ckpt) and meta.actual_tokens == len(ids), meta
    written = sorted(str(q.relative_to(root)) for q in root.rglob("*.json"))
    for rel in written:
        value = json.loads((root / rel).read_text())
        for where, number in walk_numbers(value, rel):
            assert math.isfinite(number), (where, number)
        if rel in STUDY_JSON:
            kind, keys = STUDY_JSON[rel]
            items = [value] if kind == "object" else value if kind == "records" else list(value.values())
            allowed = keys if isinstance(keys[0], tuple) else (keys,)
            assert items and all(tuple(item) in allowed for item in items), rel
    results = json.loads((root / "fits" / "fit_results.json").read_text())
    n_heads = min(TEXT_CONFIG["num_key_value_heads"], 4)  # the sweep's heads a layer
    assert len(results) == TEXT_GROUPS * len(TEXT_SWEEP_LAYERS) * n_heads * 2, len(results)
    assert sorted({r["layer"] for r in results}) == TEXT_SWEEP_LAYERS
    scaling_data = json.loads((root / "scaling" / "scaling_results.json").read_text())
    assert [int(k) for k in scaling_data] == list(SCALING_LADDER)
    prompts = json.loads((root / "multi_prompt" / "multi_prompt_results.json").read_text())
    assert list(prompts) == list(PROMPTS)
    latency = json.loads((root / "figures" / "latency_results.json").read_text())
    assert len(latency) == 8
    k_cos = np.mean([r["final_cosine_mean"] for r in results if r["kv_type"] == "key"])
    v_cos = np.mean([r["final_cosine_mean"] for r in results if r["kv_type"] == "value"])
    print(f"  {len(written)} JSON artifacts with finite numbers (the study's keys where the synthetic study writes "
          f"the same file); {len(results)} fits on layers {TEXT_SWEEP_LAYERS}: mean CosSim K {k_cos:.4f} / V "
          f"{v_cos:.4f}; scaling actual tokens "
          + ", ".join(f"{k}: {v['actual_tokens']}" for k, v in scaling_data.items())
          + "; prompts' tokens " + ", ".join(f"{k}: {v['actual_tokens']}" for k, v in prompts.items()))

    # measure_entropy --model on the Llama checkpoint.
    with counting_loads():
        timed("measure_entropy --model (Llama, S=512)", lambda: measure_entropy.main(
            ["--model", str(ckpt), "--out", str(tmp / "text_entropy.json")]))
    ent = json.loads((tmp / "text_entropy.json").read_text())
    grid = np.asarray(ent["entropy_nats"])
    assert grid.shape == (TEXT_CONFIG["num_hidden_layers"], TEXT_CONFIG["num_key_value_heads"]), grid.shape
    assert np.all(np.isfinite(grid)) and np.all(grid > 0), grid
    assert np.all(grid <= np.log(ent["seq_len"]) + 1e-3) and ent["model"] == str(ckpt) and not ent["attn_sinks"]
    print(f"  measure_entropy --model: {grid.shape} entropies {grid.min():.3f}-{grid.max():.3f} nats at "
          f"S={ent['seq_len']} (uniform {ent['uniform_entropy_nats']:.3f})")
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()

    # DeepSeek-V2-Lite, 2 layers, with the same tokenizer: extract --backend jax and measure_entropy --model.
    mconfig = mla.MLAConfig.from_hf_dict({**V2_LITE, "num_hidden_layers": 2})
    mckpt = tmp / "v2_lite_text"
    drawn = draw_v2_lite(dev, mconfig)
    timed("write V2-Lite (2 layers, bf16)", lambda: write_checkpoint(
        mckpt, {**V2_LITE, "num_hidden_layers": 2, "num_key_value_heads": 16, "torch_dtype": "bfloat16"}, drawn))
    del drawn
    for name in TEXT_FILES:
        shutil.copy(repo / TEXT_TOKENIZER / name, mckpt / name)
    with counting_loads():
        out = tmp / "text_extract_mla"
        timed("extract --backend jax (V2-Lite)", lambda: extract.main(
            ["--backend", "jax", "--model", str(mckpt), "--seq_len", str(TEXT_SEQ), "--output_dir", str(out)]))
        _, mparams = mla.load_mla_params(mckpt, dtype=torch.bfloat16, device=dev)
        want = [t.float().cpu().numpy() for t in mla.mla_prefill_kv(mconfig, mparams, ids, return_latent=True)]
        del mparams
        meta = kvstore.load_metadata(out)
        assert (meta.num_layers, meta.num_kv_heads, meta.head_dim, meta.v_head_dim, meta.actual_tokens) == (
            2, mconfig.num_attention_heads, mconfig.qk_head_dim, mconfig.v_head_dim, len(ids)), meta
        for i in range(2):
            k, v = kvstore.load_layer(out, i)
            assert np.array_equal(k, want[0][i]) and np.array_equal(v, want[1][i]), i
        assert np.array_equal(np.load(out / "latents.npy"), want[2])
        print(f"  extract --backend jax on V2-Lite: K {want[0].shape[1:]} and V {want[1].shape[1:]} a layer, "
              f"latents.npy {want[2].shape}, v_head_dim {meta.v_head_dim}; equal to mla_prefill_kv's bit for bit")
        timed("measure_entropy --model (V2-Lite, S=512)", lambda: measure_entropy.main(
            ["--model", str(mckpt), "--out", str(tmp / "text_entropy_mla.json")]))
    assert [name for name, _ in loads[-3:]] == ["load_mla_params"] * 3, loads[-3:]
    ment = json.loads((tmp / "text_entropy_mla.json").read_text())
    assert ment["mla_latent"] and len(ment["entropy_nats"]) == 2
    assert all(math.isfinite(e[0]) and e[0] > 0 for e in ment["entropy_nats"]), ment["entropy_nats"]
    print(f"  measure_entropy --model on V2-Lite: MLA detected, per-layer entropies "
          f"{[round(e[0], 4) for e in ment['entropy_nats']]} at S={ment['seq_len']}")
    shutil.rmtree(mckpt)
    torch.cuda.empty_cache()
    print("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    print("  checkpoint reads: " + ", ".join(f"{name} {sec:.2f}s" for name, sec in loads))
    return {k: v - start_counts[k] for k, v in launches().items()}, err


def draw_gpt_oss(dev, seed: int = 0) -> dict:
    """GPT_OSS_20B's tensors under their HF names and layouts (``GptOssForCausalLM.state_dict()``), bf16, drawn on
    the card from ``torch.Generator(seed)``. Projections N(0, 0.02), biases N(0, 0.02), sinks N(0, 1), norms
    1 + N(0, 0.1). The router's biases are a permutation of 0.25 steps from -4 and its weights N(0, 0.001), so
    each token's top 4 lie 0.25 clear of the fifth (bf16's step there is 1/32) and the prefill and the decode step
    route alike."""
    import torch

    c = GPT_OSS_20B
    g = torch.Generator(device=dev).manual_seed(seed)
    h, i_sz, e = c["hidden_size"], c["intermediate_size"], c["num_local_experts"]
    nq, nkv = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]

    def normal(*shape, std=0.02, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * std + mean).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": normal(c["vocab_size"], h)}
    for layer in range(c["num_hidden_layers"]):
        p = f"model.layers.{layer}"
        for name, rows in (("q_proj", nq), ("k_proj", nkv), ("v_proj", nkv)):
            t[f"{p}.self_attn.{name}.weight"] = normal(rows, h)
            t[f"{p}.self_attn.{name}.bias"] = normal(rows)
        t[f"{p}.self_attn.o_proj.weight"] = normal(h, nq)
        t[f"{p}.self_attn.o_proj.bias"] = normal(h)
        t[f"{p}.self_attn.sinks"] = normal(c["num_attention_heads"], std=1.0)
        t[f"{p}.mlp.router.weight"] = normal(e, h, std=0.001)
        t[f"{p}.mlp.router.bias"] = (torch.randperm(e, generator=g, device=dev) * 0.25 - 4.0).to(torch.bfloat16)
        t[f"{p}.mlp.experts.gate_up_proj"] = normal(e, h, 2 * i_sz)
        t[f"{p}.mlp.experts.gate_up_proj_bias"] = normal(e, 2 * i_sz)
        t[f"{p}.mlp.experts.down_proj"] = normal(e, i_sz, h)
        t[f"{p}.mlp.experts.down_proj_bias"] = normal(e, h)
        t[f"{p}.input_layernorm.weight"] = normal(h, std=0.1, mean=1.0)
        t[f"{p}.post_attention_layernorm.weight"] = normal(h, std=0.1, mean=1.0)
    t["model.norm.weight"] = normal(h, std=0.1, mean=1.0)
    t["lm_head.weight"] = normal(c["vocab_size"], h)
    return t


def gpt_oss_leaves(t: dict, layer: int) -> dict:
    """The loader's mapping, written out: each leaf of a layer from its HF tensor (transposed where HF stores
    (out, in))."""
    p = f"model.layers.{layer}"
    tr = {"q": "self_attn.q_proj.weight", "k": "self_attn.k_proj.weight", "v": "self_attn.v_proj.weight",
          "o": "self_attn.o_proj.weight", "router": "mlp.router.weight"}
    as_is = {"q_bias": "self_attn.q_proj.bias", "k_bias": "self_attn.k_proj.bias", "v_bias": "self_attn.v_proj.bias",
             "o_bias": "self_attn.o_proj.bias", "sinks": "self_attn.sinks", "router_bias": "mlp.router.bias",
             "gate_up": "mlp.experts.gate_up_proj", "gate_up_bias": "mlp.experts.gate_up_proj_bias",
             "moe_down": "mlp.experts.down_proj", "moe_down_bias": "mlp.experts.down_proj_bias",
             "input_norm": "input_layernorm.weight", "post_norm": "post_attention_layernorm.weight"}
    return {**{k: t[f"{p}.{v}"].T for k, v in tr.items()}, **{k: t[f"{p}.{v}"] for k, v in as_is.items()}}


def gpt_oss_bounds(c: dict, s: int) -> dict:
    """``bound`` (bf16) of phase 21's prefill of ``s`` tokens and of its decode step at position ``s``, each for
    the function the model defines ("function": a token through its top-k experts) and for the all-experts MoE the
    port computes as JAX does ("dense"). Bytes: the weights a pass needs, each read once, the embedding rows, the
    K/V the prefill writes or the step reads. The prefill's bytes count every expert read (its tokens may route to
    fewer); at these widths its operations bound it either way."""
    h, i, e, k = c["hidden_size"], c["intermediate_size"], c["num_local_experts"], c["num_experts_per_tok"]
    heads, kv, d = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    windows = [c["sliding_window"] if t == "sliding_attention" else None for t in c["layer_types"]]
    macs = lambda n: h * (heads + 2 * kv) * d + heads * d * h + h * e + n * 3 * h * i  # q k v o, router, experts
    params = lambda n: macs(n) + (heads + 2 * kv) * d + h + heads + e + n * (2 * i + h) + 2 * h  # biases, sinks, norms
    step_rows = [s if w is None else min(s, w) for w in windows]
    prefill_rows = [s * (s + 1) // 2 if w is None else sum(min(q + 1, w) for q in range(s)) for w in windows]
    out = {}
    for name, n in (("function", k), ("dense", e)):
        out[f"prefill {name}"] = bound(
            sum(2 * s * macs(n) + 4 * heads * d * rows for rows in prefill_rows),
            2 * (len(windows) * params(e) + s * h + len(windows) * 2 * kv * d * s), PEAK_BF16_FLOPS)
        out[f"step {name}"] = bound(
            sum(2 * macs(n) + 4 * heads * d * rows for rows in step_rows),
            2 * (len(windows) * params(n) + h + sum(2 * kv * d * rows for rows in step_rows)), PEAK_BF16_FLOPS)
    return out


def draw_v2_lite(dev, config, seed: int = 1) -> dict:
    """A 2-layer V2_LITE's tensors under their HF names and layouts (``DeepseekV2ForCausalLM``), bf16, drawn on
    the card: layer 0 dense, layer 1 the 64-expert MoE with its shared experts; N(0, 0.02), norms 1 + N(0, 0.1)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, std=0.02, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * std + mean).to(torch.bfloat16)

    h, n_q = config.hidden_size, config.num_attention_heads
    t = {"model.embed_tokens.weight": normal(config.vocab_size, h)}
    for layer in range(config.num_hidden_layers):
        p = f"model.layers.{layer}"
        t[f"{p}.self_attn.q_proj.weight"] = normal(n_q * config.qk_head_dim, h)
        t[f"{p}.self_attn.kv_a_proj_with_mqa.weight"] = normal(config.latent_dim, h)
        t[f"{p}.self_attn.kv_a_layernorm.weight"] = normal(config.kv_lora_rank, std=0.1, mean=1.0)
        t[f"{p}.self_attn.kv_b_proj.weight"] = normal(n_q * (config.qk_nope_head_dim + config.v_head_dim),
                                                      config.kv_lora_rank)
        t[f"{p}.self_attn.o_proj.weight"] = normal(h, n_q * config.v_head_dim)
        if layer < config.num_dense_layers:
            for name, shape in (("gate_proj", (config.intermediate_size, h)), ("up_proj", (config.intermediate_size, h)),
                                ("down_proj", (h, config.intermediate_size))):
                t[f"{p}.mlp.{name}.weight"] = normal(*shape)
        else:
            mi, si = config.moe_intermediate_size, config.moe_intermediate_size * config.n_shared_experts
            for j in range(config.n_routed_experts):
                for name, shape in (("gate_proj", (mi, h)), ("up_proj", (mi, h)), ("down_proj", (h, mi))):
                    t[f"{p}.mlp.experts.{j}.{name}.weight"] = normal(*shape)
            t[f"{p}.mlp.gate.weight"] = normal(config.n_routed_experts, h)
            for name, shape in (("gate_proj", (si, h)), ("up_proj", (si, h)), ("down_proj", (h, si))):
                t[f"{p}.mlp.shared_experts.{name}.weight"] = normal(*shape)
        t[f"{p}.input_layernorm.weight"] = normal(h, std=0.1, mean=1.0)
        t[f"{p}.post_attention_layernorm.weight"] = normal(h, std=0.1, mean=1.0)
    t["model.norm.weight"] = normal(h, std=0.1, mean=1.0)
    return t


def v2_lite_params(t: dict, config) -> dict:
    """The MLA loader's mapping, written out: the port's layer dicts from the HF tensors."""
    import torch

    layers = []
    for layer in range(config.num_hidden_layers):
        p = f"model.layers.{layer}"
        lp = {"kv_a": t[f"{p}.self_attn.kv_a_proj_with_mqa.weight"].T, "kv_a_norm": t[f"{p}.self_attn.kv_a_layernorm.weight"],
              "kv_b": t[f"{p}.self_attn.kv_b_proj.weight"].T, "o": t[f"{p}.self_attn.o_proj.weight"].T,
              "input_norm": t[f"{p}.input_layernorm.weight"], "post_norm": t[f"{p}.post_attention_layernorm.weight"],
              "q": t[f"{p}.self_attn.q_proj.weight"].T}
        if layer < config.num_dense_layers:
            lp.update(gate=t[f"{p}.mlp.gate_proj.weight"].T, up=t[f"{p}.mlp.up_proj.weight"].T,
                      down=t[f"{p}.mlp.down_proj.weight"].T)
        else:
            lp["router"] = t[f"{p}.mlp.gate.weight"].T
            for ours, hf in (("w1", "gate_proj"), ("w3", "up_proj"), ("w2", "down_proj")):
                lp[ours] = torch.stack([t[f"{p}.mlp.experts.{j}.{hf}.weight"].T for j in range(config.n_routed_experts)])
            for ours, hf in (("shared_gate", "gate_proj"), ("shared_up", "up_proj"), ("shared_down", "down_proj")):
                lp[ours] = t[f"{p}.mlp.shared_experts.{hf}.weight"].T
        layers.append({k: v.contiguous() for k, v in lp.items()})
    return {"embed": t["model.embed_tokens.weight"], "layers": layers}


def families_at_gpt_oss_width(dev, tmp: Path, experiments_cli, median_ms, check_train) -> tuple[dict, dict]:
    """Phase 21: the GPT-OSS-20B-width checkpoint written and read back bit for bit, its prefill and decode step, 2A
    and 2C on its K/V with those units swapped into a decode; a 2-layer V2-Lite read by load_mla_params and 2G's
    absorbed step on it; experiments head_policy on each stress axis. 2A, 2C and 2G are held to their plain
    versions at each shape the phase gives them, outside the counts. Returns the launches of 2A, 2C and 2G, and
    the largest error of each against its plain version."""
    import shutil

    import torch

    from nerf_attention_tpu_torch.experiments.attention_error import _reconstruct
    from nerf_attention_tpu_torch.models import llama, mla
    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda, siren_cuda, siren_train_cuda
    from nerf_attention_tpu_torch.parallel.sweep import fit_batch, normalize_targets
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    err = {"siren_train_grads": 0.0, "siren_decode_batch": 0.0, "mla_absorbed_attention": 0.0}

    def hold_siren(targets, params, tag: str, fitted=None) -> None:
        """One 2A step on ``targets`` and one 2C decode at ``params`` (the fit's start) and, where given, at the
        ``fitted`` params (the rebuild), each against its plain version; fast sine, as the path runs them."""
        net = CONFIGS_BY_NAME["small"]
        targets_norm = normalize_targets(targets)[0].contiguous()
        stacks = {"initial": params, **({"fitted": fitted} if fitted is not None else {})}
        with uncounted():
            for when, p in stacks.items():
                stack = SirenStack.from_params([(torch.as_tensor(w), torch.as_tensor(b)) for w, b in p])
                stack = SirenStack(stack.flat.to(dev), stack.dims)
                err["siren_train_grads"] = max(err["siren_train_grads"], check_train(
                    stack, targets_norm, f"siren_train_grads {tag} fast, {when} params", TRAIN_TOL["fast"],
                    omega=net.omega_0, sin_impl="fast"))
                got = siren_cuda.siren_decode_batch(stack, net.omega_0, targets.shape[1], sin_impl="fast")
                want = siren_cuda.siren_decode_plain(stack, net.omega_0, targets.shape[1], sin_impl="fast")
                torch.cuda.synchronize()
                err["siren_decode_batch"] = max(err["siren_decode_batch"], check_close(
                    f"siren_decode_batch {tag} fast, {when} params", got, want, **DECODE_TOL))

    for counts, key in ((siren_train_cuda.launches, "siren_train_grads"), (siren_cuda.launches, "siren_decode_batch"),
                        (mla_absorbed_cuda.launches, "mla_absorbed_attention")):
        counts[key] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    print(f"  {nvidia_smi_line()}")
    c, s = GPT_OSS_20B, FAMILY_SEQ
    print(f"  GPT-OSS-20B widths: hidden {c['hidden_size']}, {c['num_attention_heads']} query / "
          f"{c['num_key_value_heads']} KV heads, head_dim {c['head_dim']}, {c['num_local_experts']} experts top-"
          f"{c['num_experts_per_tok']} of width {c['intermediate_size']}, windows {c['layer_types']} of "
          f"{c['sliding_window']}, YaRN {c['rope_scaling']}; cuts: {'; '.join(FAMILY_CUTS)}")

    # (1) the checkpoint: drawn on the card, written as two bf16 shards with their index, read back.
    t0 = time.perf_counter()
    drawn = draw_gpt_oss(dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for name, x in drawn.items() if name != "lm_head.weight")
    print(f"  drawn on the card: {n_params / 1e9:.3f} G parameters without the LM head, "
          f"{time.perf_counter() - t0:.2f}s")
    ckpt = tmp / "gpt_oss_20b_cut"
    t0 = time.perf_counter()
    nbytes = write_checkpoint(ckpt, c, drawn)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    config, params = llama.load_llama_params(ckpt, device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    print(f"  checkpoint: {nbytes / 1e9:.3f} GB in 2 shards, written in {write_s:.2f}s, read by load_llama_params "
          f"(bf16, to the card) in {read_s:.2f}s")
    assert (config.attn_sinks, config.moe_style, config.layer_windows, config.yarn_factor) == (
        True, "gpt_oss", (c["sliding_window"], None), 32.0)
    assert torch.equal(params["embed"], drawn["model.embed_tokens.weight"])
    for layer, lp in enumerate(params["layers"]):
        want = gpt_oss_leaves(drawn, layer)
        assert sorted(lp) == sorted(want), sorted(set(lp) ^ set(want))
        for name, leaf in lp.items():
            assert leaf.dtype == torch.bfloat16 and torch.equal(leaf, want[name]), (layer, name)
    print(f"  every loaded leaf ({sum(len(lp) for lp in params['layers'])} and the embedding) equals the drawn "
          "tensor under the loader's mapping, bit for bit")
    shutil.rmtree(ckpt)
    del drawn

    # (2) prefill at S and the decode step at position S against the prefill of S + 1 tokens.
    ids = np.random.RandomState(0).randint(0, c["vocab_size"], s + 1)
    prefill_ms = median_ms(lambda: llama.llama_prefill_kv(config, params, ids[:s]), 1)
    keys, values = llama.llama_prefill_kv(config, params, ids[:s + 1])
    ck, cv = keys[:, :, :s].contiguous(), values[:, :, :s].contiguous()
    step = lambda: llama.llama_decode_step(config, params, int(ids[s]), s, ck, cv, capture_ffn_input=True,
                                           capture_sink_mass=True)
    decode_ms = median_ms(step, 5)
    h_true, (k_new, v_new), ent, ffn_x, smass = step()
    for what, new, full in (("K", k_new, keys), ("V", v_new, values)):
        gap = (new[:, :, 0].float() - full[:, :, s].float()).abs().max().item()
        top = full[:, :, s].float().abs().max().item()
        cos = cosine(new[:, :, 0], full[:, :, s])
        print(f"  decode at {s} against the prefill's row {s}: {what} max |diff| {gap:.4e} of max |{what}| "
              f"{top:.4f} (limit {FAMILY_BF16_REL} of it), cosine {cos:.6f} (>= 0.999)")
        assert gap <= FAMILY_BF16_REL * top and cos >= 0.999, (what, gap, top, cos)
    assert torch.isfinite(h_true.float()).all() and torch.isfinite(ent).all()
    for layer, lp in enumerate(params["layers"]):
        logits = (ffn_x[layer, 0].float() @ lp["router"].float() + lp["router_bias"].float()).sort(descending=True)[0]
        print(f"  layer {layer} ({'sliding ' + str(config.layer_windows[layer]) if config.layer_windows[layer] else 'full'}): entropy "
              f"{ent[layer].min().item():.3f}-{ent[layer].max().item():.3f} nats, sink mass mean "
              f"{smass[layer].mean().item():.4f} ({smass[layer].min().item():.4f}-{smass[layer].max().item():.4f}); "
              f"the new token's router margin top-4 over 5th {(logits[3] - logits[4]).item():.4f}")
    print(f"  prefill S={s}: {prefill_ms:.3f} ms; decode step: {decode_ms:.3f} ms (CUDA events, median of 3)")
    for name, b in gpt_oss_bounds(c, s).items():
        took = prefill_ms if name.startswith("prefill") else decode_ms
        print(f"    bound of the {name} (bf16 peak): {b['bound_ms']:.4f} ms ({b['bound_by']}); measured "
              f"{took / b['bound_ms']:.1f}x it")

    # (3) the head-policy pattern at this width: KV head 0 of each layer fitted by 2A and rebuilt by 2C.
    net = CONFIGS_BY_NAME["small"]
    targets = torch.stack([x for layer in range(2) for x in (ck[layer, 0], cv[layer, 0])]).float().cpu().numpy()
    t0 = time.perf_counter()
    fit = fit_batch(targets, net, epochs=STUDY_EPOCHS, seed=0, device=dev)
    recon = _reconstruct(fit, np.arange(4), s, net, None, device=dev).to(torch.bfloat16)
    d = c["head_dim"]
    hold_siren(torch.from_numpy(targets).to(dev), init_siren(net, d, generator=torch.Generator().manual_seed(0), n=4),
               f"small N=4 S={s} D={d} (phase 21's fit)", fitted=fit.params)
    k_sw, v_sw = ck.clone(), cv.clone()
    for layer in range(2):
        k_sw[layer, 0], v_sw[layer, 0] = recon[2 * layer], recon[2 * layer + 1]
    h_sw = llama.llama_decode_step(config, params, int(ids[s]), s, k_sw, v_sw)[0]
    torch.cuda.synchronize()
    served_cos = cosine(h_sw, h_true)
    fit_launches = {"siren_train_grads": siren_train_cuda.launches["siren_train_grads"],
                    "siren_decode_batch": siren_cuda.launches["siren_decode_batch"]}
    want = {"siren_train_grads": STUDY_EPOCHS, "siren_decode_batch": 2}  # the fit's final evaluation, the rebuild
    print(f"  KV head 0 of both layers, K and V, {net.name} nets x {STUDY_EPOCHS} epochs, D={c['head_dim']}: fit "
          f"CosSim {', '.join(f'{x:.4f}' for x in fit.cosine_mean)}; decode with them swapped in: output cosine "
          f"{served_cos:.6f} against the true cache; {time.perf_counter() - t0:.1f}s; launches {fit_launches} "
          f"(expected {want})")
    assert fit_launches == want and math.isfinite(served_cos), fit_launches
    del params, keys, values, ck, cv, k_sw, v_sw, recon
    torch.cuda.empty_cache()

    # (4) DeepSeek-V2-Lite through load_mla_params, and 2G's absorbed step on its weights.
    mconfig = mla.MLAConfig.from_hf_dict({**V2_LITE, "num_hidden_layers": 2})
    hf_config = {**V2_LITE, "num_hidden_layers": 2, "num_key_value_heads": 16}
    drawn = draw_v2_lite(dev, mconfig)
    ckpt = tmp / "v2_lite_cut"
    t0 = time.perf_counter()
    nbytes = write_checkpoint(ckpt, hf_config, drawn)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded_config, loaded = mla.load_mla_params(ckpt, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    assert loaded_config == mconfig
    want_params = v2_lite_params(drawn, mconfig)
    for layer, (lp, wp) in enumerate(zip(loaded["layers"], want_params["layers"])):
        assert sorted(lp) == sorted(wp), sorted(set(lp) ^ set(wp))
        for name in lp:
            assert torch.equal(lp[name], wp[name]), (layer, name)
    assert torch.equal(loaded["embed"], want_params["embed"])
    shutil.rmtree(ckpt)
    got = mla.mla_prefill_kv(mconfig, loaded, ids[:s], return_latent=True)
    want = mla.mla_prefill_kv(mconfig, want_params, ids[:s], return_latent=True)
    for what, g, w in zip(("K", "V", "latent"), got, want):
        assert torch.equal(g, w), what
    print(f"  DeepSeek-V2-Lite, 2 layers (dense, then {mconfig.n_routed_experts} experts top-"
          f"{mconfig.num_experts_per_tok} and {mconfig.n_shared_experts} shared), bf16: {nbytes / 1e9:.3f} GB "
          f"written in {write_s:.2f}s, read by load_mla_params in {read_s:.2f}s; every leaf, and the prefill's K, V "
          f"and latent at S={s}, equal to the drawn weights' bit for bit")
    lat = got[2]
    calls, kernel = [], mla.mla_absorbed_attention  # each layer's 2G call: its inputs and outputs

    def recorded(*args, **kwargs):
        out = kernel(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    mla.mla_absorbed_attention = recorded
    try:
        h_g, lat_g, ent_g = mla.mla_decode_step_absorbed(mconfig, loaded, int(ids[s]), s, lat, attn_impl="cuda")
    finally:
        mla.mla_absorbed_attention = kernel
    h_p, lat_p, ent_p = mla.mla_decode_step_absorbed(mconfig, loaded, int(ids[s]), s, lat)
    torch.cuda.synchronize()
    for layer, (args, kwargs, out) in enumerate(calls):
        err["mla_absorbed_attention"] = max(err["mla_absorbed_attention"], check_2g(
            f"2G bf16 H={mconfig.num_attention_heads} S_buf={s} position={s}, layer {layer} of the loaded V2-Lite",
            out, mla_absorbed_cuda.mla_absorbed_attention_plain(*args, **kwargs), args[1].dtype == torch.bfloat16))
    cos = cosine(h_g, h_p)
    print(f"  2G's absorbed step at position {s} on the loaded weights against its plain step: h cosine {cos:.6f} "
          f"(>= 0.999), entropy max |diff| {(ent_g - ent_p).abs().max().item():.3e}")
    assert len(calls) == mconfig.num_hidden_layers and cos >= 0.999 and torch.isfinite(h_g.float()).all()
    assert mla_absorbed_cuda.launches["mla_absorbed_attention"] == mconfig.num_hidden_layers
    del drawn, loaded, want_params, got, want, lat
    torch.cuda.empty_cache()

    # (5) experiments head_policy at its hermetic defaults, one run a stress axis; first 2A and 2C at its shape.
    gen = torch.Generator().manual_seed(HP_SEQ)
    n_hp = 2 * HP_LAYERS * HP_KV
    hold_siren(torch.randn(n_hp, HP_SEQ, HP_DIM, generator=gen).to(dev),
               init_siren(net, HP_DIM, generator=torch.Generator().manual_seed(0), n=n_hp),
               f"small N={n_hp} S={HP_SEQ} D={HP_DIM} (head_policy's fits)")
    for axis in HP_AXES:
        t0 = time.perf_counter()
        root = tmp / f"hp_axis_{axis.replace(' ', '').replace('-', '_')}"
        experiments_cli.main(["head_policy", *axis.split(), "--results_root", str(root), "--epochs",
                              str(STUDY_EPOCHS)])
        hp = json.loads((root / "head_policy" / "head_policy_results.json").read_text())
        check_head_policy(hp, HP_LAYERS, HP_KV, HP_PAYLOADS, moe="--hp_experts" in axis)
        extra = []
        if hp["moe_routing"]:
            extra.append(f"flip rate {max(hp['moe_routing']['flip_rate']):.3f} at most")
        if hp["entropy_law_solo_cache"]:
            extra.append(f"sink-aware law R^2 {hp['entropy_law_solo_cache']['r2']:.3f}")
        print(f"    {axis}: {time.perf_counter() - t0:.1f}s{'; ' if extra else ''}{'; '.join(extra)}")
        assert "--hp_sinks" not in axis or hp["entropy_law_solo_cache"] is not None
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB of it the phase's own")
    return {"siren_train_grads": siren_train_cuda.launches["siren_train_grads"],
            "siren_decode_batch": siren_cuda.launches["siren_decode_batch"],
            "mla_absorbed_attention": mla_absorbed_cuda.launches["mla_absorbed_attention"]}, err


def fm_depth_witness(dev) -> None:
    """The 16-layer net with fast sine and FM x64 at S=300 (hidden 32, D=16),
    on three seeds: 2C's and 2A's results, and their plain versions' on the
    card (fp32, cuBLAS), each against the same function evaluated in float64
    on the CPU (at the same fp32 positions). Printed, not asserted: it says
    whose rounding, carried through 15 sine layers, exceeds the tolerances
    there."""
    import torch

    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren, positions, siren_apply_maybe_fm
    from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda
    from nerf_attention_tpu_torch.ops.fastmath import resolve_sin
    from nerf_attention_tpu_torch.parallel.sweep import normalize_targets
    from nerf_attention_tpu_torch.types import SIRENConfig

    config = SIRENConfig(32, 14, 30.0, "deep16")
    kw = dict(sin_impl="fast", fm_mult=FM_MULT)
    x = positions(300).double()
    print("  16 layers, hidden 32, D=16, S=300, fast sine, FM x64: max abs error against float64 on the CPU")
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        cpu = SirenStack.from_params(init_siren(config, 16, generator=gen, n=3))
        gpu = SirenStack(cpu.flat.to(dev), cpu.dims)
        targets = normalize_targets(torch.randn(3, 300, 16, generator=gen))[0].contiguous()
        flat = cpu.flat.double().requires_grad_(True)
        pred = siren_apply_maybe_fm(cpu.with_flat(flat).params(), 30.0, FM_MULT, x, sin=resolve_sin("fast"))
        want_loss = ((pred - targets.double()) ** 2).mean(dim=(1, 2))
        (want_grad,) = torch.autograd.grad(want_loss.sum(), flat)
        want = pred.detach()
        kernel = siren_cuda.siren_decode_batch(gpu, 30.0, 300, **kw).cpu().double()
        plain = siren_cuda.siren_decode_plain(gpu, 30.0, 300, **kw).cpu().double()
        within = [torch.allclose(v, want, **DECODE_TOL) for v in (kernel, plain)]
        print(f"    seed {seed} decode: 2C {(kernel - want).abs().max().item():.3e} (within DECODE_TOL: {within[0]}), "
              f"plain {(plain - want).abs().max().item():.3e} ({within[1]})")
        for name, fn in (("2A", siren_train_cuda.siren_train_grads),
                         ("plain", siren_train_cuda.siren_train_grads_plain)):
            loss, grads = fn(gpu, targets.to(dev), omega=30.0, **kw)
            g = grads.flat.cpu().double()
            ok = torch.allclose(g, want_grad, **TRAIN_TOL["fm"]["grads"])
            print(f"    seed {seed} train {name}: grads {(g - want_grad).abs().max().item():.3e} (within the fm "
                  f"tolerance: {ok}), loss {(loss.cpu().double() - want_loss.detach()).abs().max().item():.3e}")


def tile_costs(dev, stack_for) -> None:
    """Each row tile the decode and attention kernels take, timed alone at the
    main paths' shapes, beside the tile the wrappers pick by ``wave_rows``;
    then the per-tile overhead, in rows, that fits these times best (the
    measurement behind ``_launch.TILE_OVERHEAD_ROWS``)."""
    import ctypes

    import torch

    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops._launch import STACK_TILE_ROWS, TILE_OVERHEAD_ROWS, stack_records
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME
    from nerf_attention_tpu_torch.utils.timing import per_launch_ms

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fits = []  # (shape, [(rows, work units, ms)])
    print(f"  tile cost: ms per launch (median of 5 samples of 20) for each tile taken; the pick of wave_rows "
          f"(overhead {TILE_OVERHEAD_ROWS} rows)")
    for name, n, seq_len in (("medium", N_FITS, SEQ_LEN), ("medium", 1, SEQ_LEN), ("large", N_FITS, SEQ_LEN),
                             ("small", PLAN_NETS, PLAN_SEQ_LEN)):
        config = CONFIGS_BY_NAME[name]
        stack = stack_for(config, n, seed=31)
        hidden, d_out, n_layers = stack.dims[0][1], stack.dims[-1][1], len(stack.dims)
        args = (stack_records(stack), n_layers, n, hidden, d_out, dev, config.omega_0, seq_len, "exact", None)
        lib = siren_cuda._library()
        rows_of = []
        for rows in STACK_TILE_ROWS:
            per_sm = ctypes.c_int(0)
            lib.siren_decode_blocks_per_sm(hidden, d_out, rows, 0, 0, per_sm)
            if per_sm.value == 0:
                continue
            plan = siren_cuda.plan(n, seq_len, hidden, d_out, False, dev.index or 0, (rows,))
            units = -(-n * plan[1] // (per_sm.value * sms)) * plan[2]
            ms = float(np.median(per_launch_ms(lambda: siren_cuda.decode_launch(*args, tiles=(rows,)), 20, 5, dev)))
            rows_of.append((rows, units, ms))
        pick = siren_cuda.plan(n, seq_len, hidden, d_out, False, dev.index or 0)[0]
        fits.append((f"2C {name} N={n} S={seq_len}", rows_of))
        print(f"    2C {name} N={n} S={seq_len}: " + ", ".join(f"{r} rows {ms:.4f}" for r, _, ms in rows_of)
              + f"; picked {pick}")
    medium = CONFIGS_BY_NAME["medium"]
    for seq_len in ATTN_SEQ_LENS:
        k, v, stats, q = attention_inputs(NUM_HEADS, 1, dev, seed=32)
        hidden, d = k.dims[0][1], k.dims[-1][1]
        lib = sa._library()
        rows_of = []
        for rows in STACK_TILE_ROWS:
            per_sm = ctypes.c_int(0)
            lib.siren_attention_blocks_per_sm(1, hidden, d, rows, 1, sa.PREC_F32, per_sm)
            if per_sm.value == 0:
                continue
            plan = sa.plan(NUM_HEADS, seq_len, 1, hidden, d, True, dev.index or 0, (rows,))
            units = -(-NUM_HEADS * plan[1] // (per_sm.value * sms)) * plan[2]
            run = lambda: sa.attention_launch(stack_records(k), stack_records(v), len(k.dims), hidden, *stats, q,
                                              medium.omega_0, seq_len, sin_impl="fast", fm_mult=None, causal=True,
                                              return_stats=False, tiles=(rows,))
            rows_of.append((rows, units, float(np.median(per_launch_ms(run, 20, 5, dev)))))
        pick = sa.plan(NUM_HEADS, seq_len, 1, hidden, d, True, dev.index or 0)[0]
        fits.append((f"2D medium N={NUM_HEADS} S={seq_len}", rows_of))
        print(f"    2D medium N={NUM_HEADS} S={seq_len} T=1: " + ", ".join(f"{r} rows {ms:.4f}" for r, _, ms in rows_of)
              + f"; picked {pick}")

    def misfit(c):  # ms ~ a * units * (rows + c), a per shape by least squares; summed squared relative error
        total = 0.0
        for _, rows_of in fits:
            x = np.array([u * (r + c) for r, u, _ in rows_of], float)
            y = np.array([ms for _, _, ms in rows_of])
            a = float(x @ y / (x @ x))
            total += float((((a * x) - y) / y) @ (((a * x) - y) / y))
        return total

    best = min(range(0, 257), key=misfit)
    print(f"  tile cost: the overhead that fits best is {best} rows a tile (misfit {misfit(best):.4f}; at "
          f"{TILE_OVERHEAD_ROWS} rows {misfit(TILE_OVERHEAD_ROWS):.4f}, at 0 rows {misfit(0):.4f})")


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
    legs = seed["hybrid_legs"]
    assert [leg["scheme"] for leg in legs] == HYBRID_LEG_SCHEMES, [leg["scheme"] for leg in legs]
    s, t, row = payload["seq_len"], payload["rollout_tokens"], HEAD_DIM * 4
    for leg in legs:
        n_srv, stats = leg["n_served"], leg["rollout_s_stats"]
        print(f"  hybrid {leg['scheme']}: {n_srv}/{n_units} units served from packed payloads "
              f"(degenerate-plan fallback: {leg['plan_degenerate_fallback']}), {leg['tokens_per_s']:.1f} tokens/s "
              f"(IQR {stats['iqr'] * 1e3:.2f} ms) against the all-cache {seed['base_tokens_per_s']:.1f}; device bytes "
              f"{leg['hbm_bytes_hybrid']} against {leg['hbm_bytes_full']} (resident payloads "
              f"{leg['resident_param_bytes']}); parity cosine vs its buffer-swap twin "
              f"{leg['parity_cos_vs_buffer_swap_min']:.9f} (>= {HYBRID_PARITY_FLOOR}); drift vs the all-cache rollout: "
              f"mean cost {leg['drift_mean_cost']:.3e}, final-step cosine {leg['drift_final_step_cosine']:.6f}")
        assert math.isfinite(leg["tokens_per_s"]) and leg["tokens_per_s"] > 0, leg["tokens_per_s"]
        assert leg["parity_cos_vs_buffer_swap_min"] >= HYBRID_PARITY_FLOOR, leg["parity_cos_vs_buffer_swap_min"]
        assert leg["hbm_bytes_full"] == 2 * n_units * (s + t) * row, leg
        assert leg["hbm_bytes_hybrid"] == (leg["resident_param_bytes"] + 2 * (n_units - n_srv) * (s + t) * row
                                           + 2 * n_srv * t * row), leg
    assert len({leg["n_served"] for leg in legs}) == 1, [leg["n_served"] for leg in legs]
    resident = [leg["resident_param_bytes"] for leg in legs[::-1]]  # int4_g128, int8_g32, fp32
    assert resident == sorted(set(resident)), resident
    print(f"  wall {seed['wall_s']:.1f}s")


def hybrid_model(dev):
    """Phases 9, 13 and 15's model: Llama-3.1-8B's widths cut to 4 layers (LLAMA_31_8B), fp32 weights drawn on
    the card from seed 0 (``draw_study_llama``: init_random_llama's recipe, whose numpy stream takes ~1 min at these
    widths); `small` K and V nets for its 32 units with their denormalization stats, from seed 1; every other KV
    head of every layer served. Returns (config, params, (k_nets, v_nets, stats), served)."""
    import torch

    from nerf_attention_tpu_torch.models.llama import LlamaConfig
    from nerf_attention_tpu_torch.tools.measure_attention_decode import attention_inputs as inputs_of
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    config = LlamaConfig.from_hf_dict(LLAMA_31_8B)
    n_kv, n_l = config.num_key_value_heads, config.num_hidden_layers
    params = draw_study_llama(config, 0, dev)
    k_nets, v_nets, stats, _ = inputs_of(CONFIGS_BY_NAME["small"], n_l * n_kv, 1, config.head_dim,
                                         torch.Generator().manual_seed(1), dev)
    served = np.zeros((n_l, n_kv), bool)
    served[:, ::2] = True
    return config, params, (k_nets, v_nets, stats), served


def random_kv(config, rows: int, dev, seed: int):
    """Random K and V caches (L, n_kv, rows, d) on the card, from a seed."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (config.num_hidden_layers, config.num_key_value_heads, rows, config.head_dim)
    return torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev)


def unserved_rows(cache, served, rows: int):
    """Per-layer (n_unserved, rows, d) copies of the unserved heads' first ``rows`` rows."""
    return [cache[l, torch_index(~served[l], cache.device), :rows].contiguous() for l in range(served.shape[0])]


def torch_index(mask, dev):
    import torch

    return torch.from_numpy(np.flatnonzero(mask)).to(dev)


def step_profile(fn, dev, median_ms, kernel: str) -> dict:
    """A decode step's ms (median of 3 samples of 10 back-to-back steps between CUDA events), its device ms and
    launches per step and the share of the kernels whose names contain ``kernel`` (torch.profiler, 3 steps)."""
    from nerf_attention_tpu_torch.utils.timing import kernel_ms_per_call

    split = kernel_ms_per_call(fn, 3, dev) or {}
    mine = [e for name, e in split.items() if any(k in name for k in kernel.split("|"))] if kernel else []
    return {"ms": median_ms(fn, 10), "device_ms": sum(e["ms"] for e in split.values()),
            "launches": sum(e["calls"] for e in split.values()), "kernel_ms": sum(e["ms"] for e in mine),
            "kernel_launches": sum(e["calls"] for e in mine)}


def show_profile(what: str, prof: dict) -> None:
    share = f", the kernel {prof['kernel_ms']:.4f} ms ({prof['kernel_launches']:g} launches)" if prof["kernel_launches"] else ""
    print(f"    {what}: {prof['ms']:.4f} ms a step, device {prof['device_ms']:.4f} ms over {prof['launches']:g} "
          f"launches{share}")


def check_hybrid(dev, median_ms, model) -> None:
    """Phase 15: the hybrid step and the quantized-cache step at Llama-3.1-8B's widths (``model``, hybrid_model's)
    against llama_decode_step over the buffers they stand for, with their times beside the fp32-cache step's."""
    import torch

    from nerf_attention_tpu_torch.models.llama import llama_decode_step
    from nerf_attention_tpu_torch.models.llama_hybrid import (
        llama_decode_step_quantcache,
        make_hybrid_decode_step,
        pack_llama_kv_cache,
    )
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.ops.kv_quant_cuda import resident_kv_bytes
    from nerf_attention_tpu_torch.ops.mla_quant_cuda import unpack_resident_latent

    config, params, (k_nets, v_nets, stats), served = model
    n_l, n_kv, d = config.num_hidden_layers, config.num_key_value_heads, config.head_dim
    omega, tok = 30.0, 7
    rows = torch_index(served.reshape(-1), dev)
    print(f"  (a) hybrid step: {int(served.sum())} of {served.size} units served (every other KV head), token {tok} "
          f"at position S; h against llama_decode_step over the reconstruction-swapped buffer")
    for seq_len in HYBRID_SEQ_LENS:
        keys, values = random_kv(config, seq_len + GARBAGE_ROWS, dev, seed=seq_len)
        for cache in (keys, values):
            cache[:, :, seq_len:] *= 1e3  # garbage past S
        exact_k, exact_v = keys[:, :, :seq_len].contiguous(), values[:, :, :seq_len].contiguous()
        ck, cv = (unserved_rows(c, served, seq_len) for c in (keys, values))
        long_ck, long_cv = (unserved_rows(c, served, seq_len + GARBAGE_ROWS) for c in (keys, values))
        dense = step_profile(lambda: llama_decode_step(config, params, tok, seq_len, exact_k, exact_v), dev,
                             median_ms, "")
        for sch in HYBRID_SCHEMES:
            t0 = time.perf_counter()
            step, info = make_hybrid_decode_step(config, params, served, k_nets.params(), v_nets.params(), *stats,
                                                 omega, scheme=sch, device=dev)
            build_s = time.perf_counter() - t0
            h = step(tok, ck, cv)
            swapped = []
            for nets, (mean, std), cache in ((k_nets, stats[:2], exact_k), (v_nets, stats[2:], exact_v)):
                sel = [(w[rows], b[rows]) for w, b in nets.params()]
                net = (siren_cuda.siren_decode_batch(sel, omega, seq_len, sin_impl="fast") if sch == "fp32" else
                       sq.siren_decode_batch_quant(sel, sch, omega, seq_len, sin_impl="fast"))
                buf = cache.clone()
                buf.view(n_l * n_kv, seq_len, d)[rows] = net * std[rows] + mean[rows]
                swapped.append(buf)
            h_ref = llama_decode_step(config, params, tok, seq_len, *swapped)[0]
            h_long = step(tok, long_ck, long_cv, position=seq_len)
            torch.cuda.synchronize()
            tag = f"hybrid step {sch} S={seq_len}"
            check_close(f"{tag} vs the swapped buffer", h, h_ref, **H_TOL)
            check_close(f"{tag}, {GARBAGE_ROWS} garbage rows past S (masked) vs the exact buffer", h_long, h, **H_TOL)
            assert torch.isfinite(h).all()
            print(f"    {tag}: payloads {info['resident_param_bytes']} B resident, packed in {build_s:.2f}s; the "
                  f"served heads' fp32 cache rows it replaces {2 * int(served.sum()) * seq_len * d * 4} B")
            if seq_len == HYBRID_SEQ_LENS[0]:  # the host work the factory does once a layer, not once a call
                layer = tuple(sq.pack_resident_params([(w[rows[:n_kv // 2]], b[rows[:n_kv // 2]]) for w, b in
                                                       nets.params()], sch) for nets in (k_nets, v_nets))
                t0 = time.perf_counter()
                for _ in range(1000):
                    sq.resident_records(layer, dev)
                print(f"    2F's layer records for a layer's {n_kv // 2} served heads ({sch}): "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} us a call on the host, built once by the factory")
            show_profile(f"{tag}", step_profile(lambda: step(tok, ck, cv), dev, median_ms,
                                                "siren_attention_kernel|merge_chunks_kernel"))
            del swapped, step
        show_profile(f"llama_decode_step over the fp32 cache S={seq_len}", dense)
        del keys, values, exact_k, exact_v, ck, cv, long_ck, long_cv

    print(f"  (b) quantized-cache step (2I per layer, T={HYBRID_GROUP}) on random K/V, token {tok} at position S; h "
          "and the new rows against llama_decode_step over the host-dequantized buffer")
    for seq_len, sch in QUANTCACHE_CASES:
        keys, values = random_kv(config, seq_len, dev, seed=seq_len + 1)
        t0 = time.perf_counter()
        pk, pv, layout = pack_llama_kv_cache(keys, values, sch)
        pack_s = time.perf_counter() - t0
        del keys, values
        kb, vb = (torch.stack([unpack_resident_latent(tuple(o.cpu() for o in ops), layout) for ops in half]).to(dev)
                  for half in (pk, pv))
        h, (k_new, v_new) = llama_decode_step_quantcache(config, params, tok, seq_len, pk, pv, layout)
        h_ref, (k_ref, v_ref), _ = llama_decode_step(config, params, tok, seq_len, kb, vb)
        torch.cuda.synchronize()
        tag = f"quantcache step {sch} S={seq_len}"
        check_close(f"{tag} h", h, h_ref, **H_TOL)
        check_close(f"{tag} k_new", k_new, k_ref, **ROW_TOL)
        check_close(f"{tag} v_new", v_new, v_ref, **ROW_TOL)
        packed_bytes = sum(resident_kv_bytes(ops) for half in (pk, pv) for ops in half)
        print(f"    {tag}: packed cache {packed_bytes} B against fp32 {2 * kb.numel() * 4} B "
              f"({2 * kb.numel() * 4 / packed_bytes:.2f}x), host packing {pack_s:.1f}s")
        show_profile(tag, step_profile(lambda: llama_decode_step_quantcache(config, params, tok, seq_len, pk, pv,
                                                                            layout), dev, median_ms,
                                       "kv_quant_attention_kernel"))
        show_profile(f"llama_decode_step over the fp32 cache S={seq_len}",
                     step_profile(lambda: llama_decode_step(config, params, tok, seq_len, kb, vb), dev, median_ms, ""))
        del pk, pv, kb, vb


# Phase 3's bf16 modes of 2D / 2F (the ladder's 8 medium heads) and 2E (the plan path's 128 `small` nets, and the
# ladder's 8 medium key nets at its first and last S, as a two-pass leg over packed weights would run it), as the
# JAX kernels' compute_dtype=bfloat16 computes them: (S, T, causal) for the attention kernels.
BF16_ATTN_CASES = ((2048, 1, False), (32768, 1, False), (2048, 16, True))
BF16_SCHEME = "int4_g128"
BF16_DECODE_LENS = (2048, 32768)  # 2E on the ladder's key nets (BF16_ATTN_CASES' T=1 cases)
# The control of each bf16 mode: the fp32 mode's output on the same inputs sits at least MODE_GAIN times farther
# (relative RMS) from the bf16 plain version than the bf16 mode's own output does.
MODE_GAIN = 2.0
# 2D's bf16 kernel rounds its bias tables and layer 0 row to bf16: the plain version with either left fp32 sits at
# least TABLE_GAIN times farther (relative RMS) from the bf16 plain version than the kernel does (``check_tables``).
TABLE_GAIN = 10.0
# The Hopper kernels of the bf16 modes and the layer stack on the same call are timed in turn, ALTERNATIONS samples
# each (one sample: ALTERNATION_REPS back-to-back calls between CUDA events), so that a drift of the card or the host
# moves both.
ALTERNATIONS, ALTERNATION_REPS = 7, 30
# Phase 23: the shared-basis study at its defaults (Llama-3.1-8B's KV geometry, layer 16, widths 64-512, the three
# baseline configs), and the MLA latent study at DeepSeek-V2-Lite's attention widths (phase 10's configuration;
# huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json), cut to 4 layers of 27 and S=2048; both at 200 epochs.
SHARED_WIDTHS, SHARED_CONFIGS = (64, 128, 256, 512), ("tiny", "small", "medium")
LATENT_KW = dict(seq_len=SEQ_LEN, num_layers=4, num_heads=16, kv_lora_rank=512, qk_nope_head_dim=128,
                 qk_rope_head_dim=64, v_head_dim=128, hidden_size=2048, intermediate_size=10944)
LATENT_CONFIGS = ("tiny", "small", "medium")
STUDIES_EPOCHS = 100  # phase 23's shared-basis and MLA latent studies: 100 of 2000 (their fits are the host's)
LATENT_CUTS = ["layers 4 of 27 (all dense)", f"epochs {STUDIES_EPOCHS} of 2000", "vocabulary 512 (the tool's)"]
PROFILE_EPOCHS = 20  # fit --quick --profile_dir on phase 4's cache: 2 groups of this many 2A steps
TRAIN_KERNELS = ("first_layer_kernel", "gemm_3xtf32", "finish_kernel")  # csrc/siren_train.cu's launches a step


def check_ulps(what: str, got, want) -> float:
    """A bf16 mode against its plain version: within BF16_ULPS bf16 ulps of the largest |want| (any dtype)."""
    err = (got.float() - want.float()).abs().max().item()
    limit = BF16_ULPS * 2.0**-8 * want.float().abs().max().item()
    print(f"  {what}: max_abs_err={err:.3e} (limit {limit:.3e}, {BF16_ULPS} bf16 ulps of max|y|)")
    assert err <= limit, (what, err, limit)
    return err


def rel_rms(got, want) -> float:
    """RMS of got - want over the RMS of want."""
    want = want.float()
    return ((got.float() - want).square().mean().sqrt() / want.square().mean().sqrt()).item()


def check_mode(what: str, got, fp32, want) -> float:
    """Control of a bf16 mode: its output differs from the fp32 mode's on the same inputs (fp32 in got's
    dtype), and its plain version ``want`` tells the two apart: the fp32 mode's output sits at least MODE_GAIN
    times farther from it in relative RMS than got does. Returns that ratio."""
    import torch

    fp32 = fp32.to(got.dtype)
    assert not torch.equal(got, fp32), f"{what}: the bf16 mode returned the fp32 mode's output"
    near, far = rel_rms(got, want), rel_rms(fp32, want)
    gain = far / near if near > 0 else math.inf
    print(f"  {what}: relative RMS from the bf16 plain version {near:.3e}, the fp32 mode's {far:.3e} "
          f"({gain:.1f}x, at least {MODE_GAIN:g}x)")
    assert gain >= MODE_GAIN, (what, near, far)
    return gain


def check_tables(what: str, k, v, stats, q, omega: float, seq_len: int, kw: dict) -> float:
    """2D's bf16 kernel rounds its bias tables and layer 0 row: the plain version with the biases, or with layer 0's
    weight row, left fp32 (the rest rounded as in the bf16 mode) sits at least TABLE_GAIN times farther (relative
    RMS) from the bf16 plain version than the kernel does, on each net's side: the key net's through the softmax
    max m (the kernel's launch with its stats; p's rounding does not reach m), the value net's through the output
    at q = 0 (every score 0, p = 1 exactly). Returns the least ratio."""
    import torch

    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops._launch import stack_records

    def params(stack, table):
        rounded = lambda x: x.to(torch.bfloat16).float()
        return [(w if i == 0 and table == "layer0" else rounded(w), b if table == "bias" else rounded(b))
                for i, (w, b) in enumerate(stack.params())]

    bf16, zero = torch.bfloat16, torch.zeros_like(q)
    _, got_m, _ = sa.wgmma_attention_launch(stack_records(k), stack_records(v), len(k.dims), k.dims[0][1], *stats, q,
                                            omega, seq_len, return_stats=True, round_weights=True, **kw)
    got_zero = sa.siren_attention_decode_fused(k, v, *stats, zero, omega, seq_len, compute_dtype=bf16, **kw)
    want_m = sa.siren_attention_decode_plain(k, v, *stats, q, omega, seq_len, return_stats=True, compute_dtype=bf16,
                                             **kw)[1]
    want_zero = sa.siren_attention_decode_plain(k, v, *stats, zero, omega, seq_len, compute_dtype=bf16, **kw)
    near = {"m": rel_rms(got_m, want_m), "output at q = 0": rel_rms(got_zero, want_zero)}
    gains = []
    for table in ("bias", "layer0"):
        kv = (params(k, table), params(v, table), *stats)
        far = {"m": rel_rms(sa.siren_attention_decode_plain(*kv, q, omega, seq_len, return_stats=True,
                                                            compute_dtype=bf16, round_weights=False, **kw)[1],
                            want_m),
               "output at q = 0": rel_rms(sa.siren_attention_decode_plain(*kv, zero, omega, seq_len,
                                                                          compute_dtype=bf16, round_weights=False,
                                                                          **kw), want_zero)}
        for side in far:
            gains.append(far[side] / near[side] if near[side] > 0 else math.inf)
            print(f"  {what}, {side}: the plain version with {table} unrounded sits {far[side]:.3e} from the bf16 "
                  f"plain version, the kernel {near[side]:.3e} ({gains[-1]:.1f}x, at least {TABLE_GAIN:g}x)")
            assert gains[-1] >= TABLE_GAIN, (what, table, side, near[side], far[side])
    return min(gains)


def alternating_ms(runs: dict, dev) -> dict:
    """Each of ``runs``' median ms a call over ALTERNATIONS samples taken in turn (a, b, a, b, ...); each sample
    warms its run up first (``per_launch_ms``)."""
    import numpy as np

    from nerf_attention_tpu_torch.utils.timing import per_launch_ms

    samples = {name: [] for name in runs}
    for _ in range(ALTERNATIONS):
        for name, fn in runs.items():
            samples[name] += per_launch_ms(fn, ALTERNATION_REPS, 1, dev)
    return {name: float(np.median(v)) for name, v in samples.items()}


def device_ms_a_call(run, kernels: tuple[str, ...], dev) -> tuple[float | None, dict]:
    """The device time of one call of ``run``, which launches each of ``kernels`` (base names) once: the sum
    of each kernel's time over the launches torch.profiler recorded of it, with the profiler's split. A session
    counts only where it recorded exactly those kernels, each at 0.9-1.1 launches a call (a short session may drop
    some launches, or whole kernels); None, with the last session's split, where five sessions of 50 calls give
    none that counts."""
    from nerf_attention_tpu_torch.utils.timing import kernel_ms_per_call

    split = {}
    for _ in range(5):
        split = kernel_ms_per_call(run, 50, dev) or {}
        names = [next((k for k in kernels if name.removeprefix("void ").split("(")[0].split("<")[0]
                       .rsplit("::", 1)[-1] == k), None) for name in split]
        if sorted(n for n in names if n) == sorted(kernels) and None not in names and all(
                0.9 <= e["calls"] <= 1.1 for e in split.values()):
            return sum(e["ms"] / e["calls"] for e in split.values()), split
    return None, split


def check_bf16_kernels(dev, median_ms, stack_for) -> tuple[dict, dict]:
    """The bf16 modes of kernels 2D and 2F (8 medium heads, S 2048 and 32768 at T=1, T=16 causal at 2048) and 2E
    (128 `small` nets at S=512, and the key nets of the T=1 cases at their S; int4_g128). Neither package has a
    caller of these modes, so their path is their public entry points: each is called once per shape with the
    counters zeroed just before, and its launches read just after. Outside the counts (``uncounted``), each of
    those outputs is then held against its plain version (``check_ulps``) and against the fp32 mode's output on
    the same inputs (``check_mode``); 2F and 2E in bf16 on packed weights equal themselves on the
    host-dequantized weights shipped dense (max abs diff 0); each mode is timed beside its plain version and its
    fp32 mode (``fp32_ms``), and beside the layer stack's instance of its arithmetic on the same call (kBF16 for
    2D, kAct16 for 2E / 2F; ``stack_ms``, sampled in turn with the kernel: ``alternating_ms``), its device time a
    call (``device_ms``: torch.profiler's sum over the call's kernels, the split pass, the kernel and 2D / 2F's
    merge) and its floors. 2D's, 2E's and 2F's launches all go through their Hopper kernels, asserted by
    ``siren_attention_cuda.wgmma_launches`` and ``siren_quant_cuda.wgmma_launches``. Returns their report entries
    and their launches."""
    import torch

    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.ops._launch import stack_records
    from nerf_attention_tpu_torch.tools import bf16_epilogue_floor
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    bf16, omega = torch.bfloat16, 30.0
    small = CONFIGS_BY_NAME["small"]
    attn = []  # (tag, S, keyword arguments, K, V, stats, q, packed K and V)
    for seq_len, t, causal in BF16_ATTN_CASES:
        k, v, stats, q = attention_inputs(NUM_HEADS, t, dev, seed=seq_len + t + 5)
        packed = tuple(sq.pack_resident_params(s.params(), BF16_SCHEME) for s in (k, v))
        attn.append((f"N={NUM_HEADS} S={seq_len} T={t} fast causal={causal} bf16", seq_len,
                     dict(sin_impl="fast", causal=causal), k, v, stats, q, packed))
    plan_nets = stack_for(small, PLAN_NETS, seed=24)
    dec = [(f"small N={PLAN_NETS} S={PLAN_SEQ_LEN} fast bf16", small.omega_0, PLAN_SEQ_LEN,
            sq.pack_resident_params(plan_nets.params(), BF16_SCHEME))]
    dec += [(f"medium (the ladder's keys) N={NUM_HEADS} S={c[1]} fast bf16", omega, c[1], c[7][0])
            for c in attn if c[1] in BF16_DECODE_LENS and c[2]["causal"] is False]

    # Every shape here is within the width rule: 2D's, 2E's and 2F's bf16 launches all go through the Hopper kernels
    # (csrc/siren_decode_act16.cu, csrc/siren_attention_wgmma.cu), asserted by their own counts.
    assert all(sa.attention_route(k.dims[0][1], k.dims[-1][1], q.shape[1]) == "wgmma" for *_, k, _, _, q, _ in attn)
    assert all(sq.bf16_route(p[1][0][2], p[1][-1][2]) == "wgmma" for _, _, _, p in dec)

    # ---- the modes' path: each entry point once per shape ----
    bf16_counts = (sa.bf16_launches, sq.bf16_launches, sq.wgmma_launches, sa.wgmma_launches)
    for counts in bf16_counts:
        for key in counts:
            counts[key] = 0
    out_d = [sa.siren_attention_decode(k, v, *stats, q, omega, s, compute_dtype=bf16, **kw)
             for _, s, kw, k, v, stats, q, _ in attn]
    out_f = [sq.siren_attention_decode_quant(None, None, *stats, q, BF16_SCHEME, omega, s, packed=packed,
                                             compute_dtype=bf16, **kw)
             for _, s, kw, _, _, stats, q, packed in attn]
    out_e = [sq.siren_decode_batch_quant(None, BF16_SCHEME, om, s, packed=p, sin_impl="fast", compute_dtype=bf16)
             for _, om, s, p in dec]
    torch.cuda.synchronize()
    launches = {f"{key} (bf16)": counts[key] for counts in bf16_counts[:2] for key in counts}
    want = {"siren_attention_decode_fused (bf16)": len(attn), "siren_attention_decode_quant (bf16)": len(attn),
            "siren_decode_batch_quant (bf16)": len(dec)}
    wgmma = {**sq.wgmma_launches, **sa.wgmma_launches}
    want_wgmma = {"siren_decode_batch_quant": len(dec), "siren_attention_decode_quant": len(attn),
                  "siren_attention_decode_fused": len(attn)}
    print(f"  the bf16 modes' entry points once per shape: launches {launches}, expected {want}; of 2D's, 2E's and "
          f"2F's, through csrc/siren_decode_act16.cu and csrc/siren_attention_wgmma.cu {wgmma}, expected {want_wgmma}")
    assert launches == want, (launches, want)
    assert wgmma == want_wgmma, (wgmma, want_wgmma)

    err = {"2D": 0.0, "2F": 0.0, "2E": 0.0}
    gains = {"2D": [], "2F": [], "2E": []}
    tables = []
    with uncounted():
        for (tag, s, kw, k, v, stats, q, packed), got, o in zip(attn, out_d, out_f):
            want_d = sa.siren_attention_decode_plain(k, v, *stats, q, omega, s, compute_dtype=bf16, **kw)
            err["2D"] = max(err["2D"], check_ulps(f"2D {tag}", got, want_d))
            gains["2D"].append(check_mode(f"2D {tag}", got, sa.siren_attention_decode(k, v, *stats, q, omega, s,
                                                                                      **kw), want_d))
            tables.append(check_tables(f"2D {tag}", k, v, stats, q, omega, s, dict(fm_mult=None, **kw)))
            want_f, m_p, _ = sq.siren_attention_decode_quant_plain(packed, *stats, q, omega, s, return_stats=True,
                                                                     compute_dtype=bf16, **kw)
            err["2F"] = max(err["2F"], check_ulps(f"2F[{BF16_SCHEME}] {tag}", o, want_f))
            # 2F's control reads the softmax max m, each query's largest score (the K side of its stack): its
            # output cannot tell the modes apart, p being rounded against its chunk's running max there and
            # against the global max in the plain version.
            o_b, m_b, _ = sq.siren_attention_decode_quant(None, None, *stats, q, BF16_SCHEME, omega, s, packed=packed,
                                                          return_stats=True, compute_dtype=bf16, **kw)
            o_f, m_f, _ = sq.siren_attention_decode_quant(None, None, *stats, q, BF16_SCHEME, omega, s, packed=packed,
                                                          return_stats=True, **kw)
            assert torch.equal(o_b, o) and not torch.equal(o, o_f)
            gains["2F"].append(check_mode(f"2F[{BF16_SCHEME}] {tag} m", m_b, m_f, m_p))
            print(f"  2F[{BF16_SCHEME}] {tag} output (no control): relative RMS from the bf16 plain version "
                  f"{rel_rms(o, want_f):.3e}, the fp32 mode's {rel_rms(o_f, want_f):.3e}")
            dense = tuple(sq.pack_resident_params(sq.unpack_resident_params(*p), "fp32") for p in packed)
            twin = sq.siren_attention_decode_quant(None, None, *stats, q, "fp32", omega, s, packed=dense,
                                                   compute_dtype=bf16, **kw)
            diff = (o - twin).abs().max().item()
            print(f"  2F[{BF16_SCHEME}] {tag} vs 2F on the host-dequantized weights shipped dense: "
                  f"max_abs_diff={diff:.3e} (must be 0)")
            assert diff == 0.0, diff
        for (tag, om, s, p), got in zip(dec, out_e):
            kw_e = dict(sin_impl="fast", compute_dtype=bf16)
            want_e = sq.siren_decode_batch_quant_plain(p, om, s, **kw_e)
            err["2E"] = max(err["2E"], check_ulps(f"2E[{BF16_SCHEME}] {tag}", got, want_e))
            gains["2E"].append(check_mode(f"2E[{BF16_SCHEME}] {tag}", got, sq.siren_decode_batch_quant(
                None, BF16_SCHEME, om, s, packed=p, sin_impl="fast"), want_e))
            dense_e = sq.pack_resident_params(sq.unpack_resident_params(*p), "fp32")
            diff = (got.float() - sq.siren_decode_batch_quant(None, "fp32", om, s, packed=dense_e, **kw_e).float()
                    ).abs().max().item()
            print(f"  2E[{BF16_SCHEME}] {tag} vs 2E on the host-dequantized weights shipped dense: "
                  f"max_abs_diff={diff:.3e} (must be 0)")
            assert diff == 0.0, diff
        del out_d, out_f, out_e

        # Times at the ladder's first point (8 heads, S=2048, T=1, the whole window) and the plan path's 2E shape.
        _, seq_len, _, k, v, stats, q, packed = attn[0]
        _, _, _, packed_e = dec[0]
        kw = dict(sin_impl="fast", causal=False)
        macs, pbytes = siren_macs(k.dims)
        small_bytes = 6 * NUM_HEADS * HEAD_DIM * 4  # stats, q and out at T=1
        attn_flops = NUM_HEADS * (2 * 2 * macs * seq_len + 4 * seq_len * HEAD_DIM)
        shape = f"medium, N={NUM_HEADS}, S={seq_len}, D={HEAD_DIM}, T=1, fast sine, bf16 mode"
        emacs, _ = siren_macs(plan_nets.dims)
        run_e = lambda: sq.siren_decode_batch_quant(None, BF16_SCHEME, small.omega_0, PLAN_SEQ_LEN,
                                                    packed=packed_e, sin_impl="fast", compute_dtype=bf16)
        # The Hopper kernels beside the layer stack's instance of their arithmetic on the same calls (the kernel
        # these modes took before them: kBF16 for 2D, kAct16 for 2E / 2F), sampled in turn; each kernel's device
        # time a call (the split pass, the kernel, the merge); and its own floors: its products as bf16 passes at
        # the bf16 peak (one for 2D, three for 2E / 2F), and its sines' epilogue alone (tools/bf16_epilogue_floor.py,
        # the kernels' own hidden_epilogue) over the call's sines.
        k_rec, v_rec, keep_f = sq.resident_records(packed, dev)
        e_rec, keep_e = sq.packed_records(*packed_e, dev)
        run_d = lambda: sa.siren_attention_decode_fused(k, v, *stats, q, omega, seq_len, compute_dtype=bf16, **kw)
        run_f = lambda: sq.siren_attention_decode_quant(None, None, *stats, q, BF16_SCHEME, omega, seq_len,
                                                        packed=packed, compute_dtype=bf16, **kw)
        stack_d = lambda: sa.attention_launch(stack_records(k), stack_records(v), len(k.dims), k.dims[0][1], *stats,
                                              q, omega, seq_len, return_stats=False, fm_mult=None,
                                              compute_dtype=bf16, **kw)
        stack_f = lambda: sa.attention_launch(k_rec, v_rec, len(k.dims), k.dims[0][1], *stats, q, omega, seq_len,
                                              return_stats=False, fm_mult=None, compute_dtype=bf16,
                                              round_weights=False, **kw)
        stack_e = lambda: siren_cuda.decode_launch(e_rec, len(plan_nets.dims), PLAN_NETS, small.hidden_features,
                                                   HEAD_DIM, dev, small.omega_0, PLAN_SEQ_LEN, "fast", None,
                                                   compute_dtype=bf16, round_weights=False)
        sines_f = NUM_HEADS * seq_len * 2 * (len(k.dims) - 1) * k.dims[0][1]
        sines_e = PLAN_NETS * PLAN_SEQ_LEN * (len(plan_nets.dims) - 1) * small.hidden_features
        floors = {"2F": bf16_epilogue_floor.floor(sines_f, dev), "2E": bf16_epilogue_floor.floor(sines_e, dev)}
        # The layer stack's output on the timing shape, held to the same plain version as the kernel's.
        want_d = sa.siren_attention_decode_plain(k, v, *stats, q, omega, seq_len, compute_dtype=bf16, **kw)
        stack_err = {"2D": check_ulps("2D's layer stack (kBF16) at the timing shape", stack_d(), want_d)}
        check_mode("2D's layer stack (kBF16) at the timing shape", stack_d(),
                   sa.siren_attention_decode(k, v, *stats, q, omega, seq_len, **kw), want_d)
        stack_err["2F"] = check_ulps("2F's layer stack (kAct16) at the timing shape", stack_f(),
                                     sq.siren_attention_decode_quant_plain(packed, *stats, q, omega, seq_len,
                                                                           compute_dtype=bf16, **kw))
        stack_err["2E"] = check_ulps("2E's layer stack (kAct16) at the plan shape", stack_e(),
                                     sq.siren_decode_batch_quant_plain(packed_e, small.omega_0, PLAN_SEQ_LEN,
                                                                       sin_impl="fast", compute_dtype=bf16))
        attention_kernels = ("attention_wgmma_kernel", "merge_chunks_kernel", "split_kernel")
        times = {}
        for name, run, stack, kernels in (("2D", run_d, stack_d, attention_kernels),
                                          ("2F", run_f, stack_f, attention_kernels),
                                          ("2E", run_e, stack_e, ("decode_act16_kernel", "split_kernel"))):
            times[name] = alternating_ms({"ms": run, "stack_ms": stack}, dev)
            times[name]["device_ms"], split = device_ms_a_call(run, kernels, dev)
            recorded = ", ".join(f"{kname[:48]} {e['ms']:.4f} ms x{e['calls']:g}" for kname, e in split.items())
            print(f"  {name} bf16, device time a call (torch.profiler): "
                  + (f"{times[name]['device_ms']:.4f} ms over {recorded}" if times[name]["device_ms"] is not None
                     else f"not measured (no session recorded exactly {', '.join(kernels)} once a call; the last: "
                          f"{recorded or 'no kernel'})"))
        own = {"2D": dict(bf16_passes_ms=attn_flops / PEAK_BF16_FLOPS * 1e3,
                          epilogue_floor_fast_ms=floors["2F"]["fast"]["probe_ms"], sines=sines_f, **times["2D"]),
               "2F": dict(bf16_passes_ms=3 * attn_flops / PEAK_BF16_FLOPS * 1e3,
                          epilogue_floor_fast_ms=floors["2F"]["fast"]["probe_ms"], sines=sines_f, **times["2F"]),
               "2E": dict(bf16_passes_ms=3 * 2 * emacs * PLAN_SEQ_LEN * PLAN_NETS / PEAK_BF16_FLOPS * 1e3,
                          epilogue_floor_fast_ms=floors["2E"]["fast"]["probe_ms"], sines=sines_e, **times["2E"])}
        del keep_f, keep_e
        report = {
            "siren_attention_decode_fused (bf16)": dict(
                max_abs_err=err["2D"], shape=shape, library_ms=None,
                plain_ms=median_ms(lambda: sa.siren_attention_decode_plain(k, v, *stats, q, omega, seq_len,
                                                                           compute_dtype=bf16, **kw), 20),
                fp32_ms=median_ms(lambda: sa.siren_attention_decode_fused(k, v, *stats, q, omega, seq_len, **kw),
                                  50),
                # bf16 products at the bf16 peak; the function reads the fp32 weights once (the split pass rounds
                # them)
                **bound(attn_flops, 2 * NUM_HEADS * pbytes + small_bytes, PEAK_BF16_FLOPS),
                **own["2D"]),
            "siren_attention_decode_quant (bf16)": dict(
                max_abs_err=err["2F"], shape=f"{shape}, {BF16_SCHEME} weights", library_ms=None,
                plain_ms=median_ms(lambda: sq.siren_attention_decode_quant_plain(packed, *stats, q, omega, seq_len,
                                                                                 compute_dtype=bf16, **kw), 20),
                fp32_ms=median_ms(lambda: sq.siren_attention_decode_quant(None, None, *stats, q, BF16_SCHEME, omega,
                                                                          seq_len, packed=packed, **kw), 50),
                # bf16 activations times fp32 weights: fp32 products at the TF32 peak (JAX's products are fp32)
                **tc_bound(attn_flops, sum(sq.resident_param_bytes(p[0]) for p in packed) + small_bytes),
                **own["2F"]),
            "siren_decode_batch_quant (bf16)": dict(
                max_abs_err=err["2E"], library_ms=None,
                shape=f"small, N={PLAN_NETS}, S={PLAN_SEQ_LEN}, D={HEAD_DIM}, fast sine, {BF16_SCHEME} weights, "
                      "bf16 mode",
                plain_ms=median_ms(lambda: sq.siren_decode_batch_quant_plain(
                    packed_e, small.omega_0, PLAN_SEQ_LEN, sin_impl="fast", compute_dtype=bf16), 20),
                fp32_ms=median_ms(lambda: sq.siren_decode_batch_quant(None, BF16_SCHEME, small.omega_0, PLAN_SEQ_LEN,
                                                                      packed=packed_e, sin_impl="fast"), 50),
                # as the fp32 mode's bound, the output written in bf16: half its bytes
                **tc_bound(2 * emacs * PLAN_SEQ_LEN * PLAN_NETS,
                           sq.resident_param_bytes(packed_e[0]) + PLAN_NETS * PLAN_SEQ_LEN * HEAD_DIM * 2),
                **own["2E"]),
        }
    print(f"  controls: the fp32 mode's relative RMS from the bf16 plain versions over the bf16 mode's, least per "
          f"mode: " + ", ".join(f"{m} {min(g):.1f}x" for m, g in gains.items())
          + f"; 2D's unrounded-table plain versions over the kernel, least {min(tables):.1f}x; the layer stacks' "
            f"max_abs_err at the timing shapes {stack_err}")
    for name, r in report.items():
        print(f"  {name} ({r['shape']}): kernel {r['ms']:.4f} ms (fp32 mode {r['fp32_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        device = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        print(f"    the Hopper kernel against the layer stack on the same call, sampled in turn: {r['ms']:.4f} / "
              f"{r['stack_ms']:.4f} ms ({r['stack_ms'] / r['ms']:.2f}x); its device time a call {device}; its "
              f"floors: its bf16 passes {r['bf16_passes_ms']:.4f} ms, the sine epilogue of its {r['sines']} sines "
              f"{r['epilogue_floor_fast_ms']:.4f} ms (fast sine, tools/bf16_epilogue_floor.py)")
    return report, launches


def studies_on_the_card(dev, tmp: Path, study_kv: Path, check_train) -> tuple[dict, dict]:
    """Phase 23: the shared-basis study at its defaults, the MLA latent study at DeepSeek-V2-Lite's attention
    widths and serve_plan --latent_json on its units, fit --quick --profile_dir on phase 4's cache (its trace
    holding 2A's kernels). Each fit_batch held at its own shape (``hold_fits``, outside the counts); 2A and 2C
    launched exactly as expected. Returns (launches, errors against the plain versions)."""
    from nerf_attention_tpu_torch import fit, serve_plan
    from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda
    from nerf_attention_tpu_torch.parallel import sweep
    from nerf_attention_tpu_torch.tools import mla_latent_study, shared_basis_study
    from nerf_attention_tpu_torch.utils import tracing

    counts = ((siren_train_cuda.launches, "siren_train_grads"), (siren_cuda.launches, "siren_decode_batch"))
    launches = {key: 0 for _, key in counts}
    err = {"siren_train_grads": 0.0, "siren_decode_batch": 0.0, "siren_decode": 0.0}

    def run(tag: str, fn, want: dict):
        for c, key in counts:
            c[key] = 0
        fits = []
        t0 = time.perf_counter()
        with tally(sweep, "fit_batch_dispatch", fits):
            out = fn()
        took = time.perf_counter() - t0
        got = {key: c[key] for c, key in counts}
        print(f"  {tag}: {took:.1f}s; launches {got} (expected {want})")
        assert got == want, (tag, got, want)
        hold_fits(tag, fits, dev, check_train, err)
        for key, n in got.items():
            launches[key] += n
        return out

    # The shared-basis study: the independent frontier (3 configs x K and V, N=8) through 2A / 2C, 16 shared fits
    # through autograd.
    n_ind = len(SHARED_CONFIGS) * 2
    print(f"  shared_basis_study: synthetic cache {NUM_LAYERS} layers x {NUM_HEADS} heads, S={SEQ_LEN}, D={HEAD_DIM}, "
          f"layer 16, widths {'/'.join(map(str, SHARED_WIDTHS))}, configs {'/'.join(SHARED_CONFIGS)}; cut: epochs "
          f"{STUDIES_EPOCHS} of 2000")
    shared = run("shared_basis_study", lambda: shared_basis_study.main(
        ["--output_dir", str(tmp / "shared_basis"), "--epochs", str(STUDIES_EPOCHS)]),
        {"siren_train_grads": n_ind * STUDIES_EPOCHS, "siren_decode_batch": n_ind})
    assert [r["config"] for r in shared["independent"]] == list(SHARED_CONFIGS) * 2
    assert len(shared["shared"]) == 2 * len(SHARED_WIDTHS) * 2
    for r in shared["independent"] + shared["shared"]:
        assert math.isfinite(r["cosine_mean"]) and -1 <= r["cosine_mean"] <= 1 and r["bytes_per_unit"] > 0, r
        if "trunk_width" in r and not r["trainable_trunk"]:
            assert r["bytes_per_unit"] == 2.0 * r["head_params_per_unit"], r
    for r in shared["shared"]:
        print(f"    shared {r['kv']} w={r['trunk_width']} {'trained' if r['trainable_trunk'] else 'frozen '}: "
              f"{r['bytes_per_unit']:.0f} B/unit, cos {r['cosine_mean']:.4f}, {r['wall_seconds']:.2f}s")

    # The MLA latent study: per config K (64 nets, D=192), V (64, D=128) and the latent (4, D=576) through 2A / 2C.
    print(f"  mla_latent_study: DeepSeek-V2-Lite attention widths {LATENT_KW}; cuts: {'; '.join(LATENT_CUTS)}")
    n_fits = 3 * len(LATENT_CONFIGS)
    latent = run("mla_latent_study", lambda: mla_latent_study.run_study(
        tmp / "mla_latent", epochs=STUDIES_EPOCHS, configs=LATENT_CONFIGS, **LATENT_KW),
        {"siren_train_grads": n_fits * STUDIES_EPOCHS, "siren_decode_batch": 2 * n_fits})
    w = LATENT_KW
    assert latent["model"]["latent_dim"] == w["kv_lora_rank"] + w["qk_rope_head_dim"]  # 576 at V2-Lite's widths
    assert latent["model"]["materialized_per_token"] == w["num_heads"] * (
        w["qk_nope_head_dim"] + w["qk_rope_head_dim"] + w["v_head_dim"])
    assert latent["baselines"]["latent_fp16"]["output_cosine"] > 0.999, latent["baselines"]["latent_fp16"]
    for name in ("materialized", "latent"):
        for r in latent["strategies"][name]:
            assert -1 <= r["output_cosine"] <= 1 and r["stored_bytes_per_layer"] > 0, r
            print(f"    {name} {r['config']}: {r['compression_vs_raw_fp16']:.1f}x, output cosine "
                  f"{r['output_cosine']:.4f}")
    for name, b in latent["baselines"].items():
        print(f"    {name}: {b['compression_vs_raw_fp16']:.1f}x, output cosine {b['output_cosine']:.6f}")
    units = tmp / "mla_latent" / "mla_latent_units.json"
    serve_plan.main(["--latent_json", str(units), "--cost_target", "0.05", "--out", str(tmp / "latent_plan.json")])
    plan = json.loads((tmp / "latent_plan.json").read_text())
    print(f"  serve_plan --latent_json: {plan['n_units']} units, {plan['n_served']} served")
    assert plan["mla_latent"] is True and plan["n_units"] == LATENT_KW["num_layers"]

    # fit --quick --profile_dir: the trace holds 2A's kernels.
    prof = tmp / "profile"
    run("fit --quick --profile_dir", lambda: fit.main(
        ["--kv_dir", str(study_kv), "--output_dir", str(tmp / "fits_profiled"), "--epochs", str(PROFILE_EPOCHS),
         "--quick", "--profile_dir", str(prof)]), {"siren_train_grads": 2 * PROFILE_EPOCHS, "siren_decode_batch": 2})
    events = json.loads((prof / tracing.TRACE_FILE).read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in names) for k in TRAIN_KERNELS}
    print(f"  trace {prof / tracing.TRACE_FILE}: {len(events)} events, {len(names)} kernel events; 2A's: {found}")
    assert all(found.values()), (found, collections.Counter(names).most_common(5))
    return launches, err


# Phase 24: the root tools of the JAX package's tools/ on the card. Each runs at its defaults but for the cuts below,
# every one printed and recorded in the tool's JSON where it has a `reduced`.
TOOL_EPOCHS = STUDY_EPOCHS  # 200 of 2000 wherever a tool fits
TOOL_WARM = 100  # the sustain study's warm epochs: 100 of 1000
TOOL_QAT = 30  # its QAT epochs: 30 of 300
TOOL_ABSORB = 50  # the lifecycle study's absorb epochs: 50 of 500
FM_SPACING_EPOCHS = 50  # fm_spacing_study's: 50 of 2000 (its learned-spacing fits step through autograd)
TRAIN_BENCH = dict(n1=5, samples=1)  # train_impl_bench: 5 and 20 epochs a replicate, 1 replicate (of 200 and 5)
DECODE_SAMPLES = 5  # measure_decode's default replicates; one is 200 launches (utils/timing.time_siren_forward_ms)
SUSTAIN_LEN = 4096  # the incremental study's cache, of which the study reads 2048 + 256 rows
HARD_LAYERS = SWEEP_LAYERS  # the FM studies' sweep layers (layer 8, FINER's, among them)
SERVE_LAYERS = 2  # the three serving studies and measure_rollout: 2 layers of Llama-3.1-8B's 32
TOOL_8B = {**LLAMA_31_8B, "vocab_size": 512}
TOOL_8B_CUTS = [f"layers {SERVE_LAYERS} of 32", "vocabulary 512 of 128256 (the studies' own model's)"]
PREFILL_LAYERS = 4  # prefill_ladder: 4 of Llama-3.2-3B's 28 layers


def draw_study_llama(config, seed: int, dev, dtype=None) -> dict:
    """A random dense Llama in ``models/llama.py``'s layout, drawn on the card from ``torch.Generator(seed)``:
    projections and the embedding N(0, 0.02), zero biases, unit norms (``init_random_llama``'s recipe, without its
    host draws)."""
    import torch

    from nerf_attention_tpu_torch.models.llama import layer_shapes

    dtype = dtype or torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    draw = lambda *shape: (torch.randn(shape, generator=g, device=dev) * 0.02).to(dtype)
    layers = []
    for _ in range(config.num_hidden_layers):
        lp = {}
        for name, shape in layer_shapes(config).items():
            if name.endswith("bias"):
                lp[name] = torch.zeros(shape, dtype=dtype, device=dev)
            elif name.endswith("norm"):
                lp[name] = torch.ones(shape, dtype=dtype, device=dev)
            else:
                lp[name] = draw(*shape)
        layers.append(lp)
    return {"embed": draw(config.vocab_size, config.hidden_size), "layers": layers}


def hold_trajectories(stage: str, calls: list, dev, check_train, err: dict) -> None:
    """Phase 24: each ``_fit_with_trajectory`` call (``tally``'s record) at its own shape: one 2A step of its
    final params against the plain version (``TRAIN_TOL``, its sine, fm_mult and total_len; with FM multipliers
    ``check_train_fp64``) and the 2C decode its trajectory points run, with the plain version's, against an fp64
    forward (``check_fp64``)."""
    from nerf_attention_tpu_torch.models.siren import positions, siren_apply_maybe_fm
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops.fastmath import resolve_sin
    from nerf_attention_tpu_torch.parallel.sweep import normalize_targets

    with uncounted():
        for _, call, (stack, _) in calls:
            targets, config = call["targets"], call["config"]
            fm, sine, total = call["fm_mult"], call["sin_impl"], call["total_len"]
            n, s = targets.shape[:2]
            tag = f"{stage} {config.name} N={n} S={s} total_len={total} fm={fm}"
            targets_norm = normalize_targets(targets)[0].contiguous()
            kw = dict(omega=config.omega_0, sin_impl=sine, fm_mult=fm, total_len=total)
            step = (check_train_fp64(stack, targets_norm, f"siren_train_grads {tag} {sine}", **kw) if fm else
                    check_train(stack, targets_norm, f"siren_train_grads {tag} {sine}", TRAIN_TOL[sine], **kw))
            err["siren_train_grads"] = max(err["siren_train_grads"], step)
            x = positions(s, total_len=total, device=dev).double()
            exact = siren_apply_maybe_fm([(w.double(), b.double()) for w, b in stack.params()], config.omega_0, fm,
                                         x, sin=resolve_sin(sine))
            dec = dict(sin_impl=sine, fm_mult=fm, total_len=total)
            err["siren_decode_batch"] = max(err["siren_decode_batch"], check_fp64(
                f"siren_decode_batch {tag} {sine}", siren_cuda.siren_decode_batch(stack, config.omega_0, s, **dec),
                siren_cuda.siren_decode_plain(stack, config.omega_0, s, **dec), exact))
    if calls:
        print(f"  stage {stage}: 2A and 2C held at {len(calls)} trajectory fits' shapes")


def hold_measure_decode(quality: list, ladder: list, aggregate: list, dev, err: dict) -> None:
    """measure_decode's decodes, as ``tally`` recorded them, each against its plain version outside the counts:
    the quality leg's 2B outputs on its two trained nets (fp32 and fast sine with the plain version against an fp64
    forward, ``check_fp64``; bf16 ``check_bf16``); 2B on the net each ladder rung timed and 2C on the 512 nets the
    aggregate timed, in the mode timed (``DECODE_TOL``; bf16 ``check_bf16``, phase 3's tolerances). 2B's errors
    in either mode go to ``err["siren_decode"]``, 2C's bf16 mode's to its own entry."""
    import torch

    from nerf_attention_tpu_torch.interop import params_from_jax
    from nerf_attention_tpu_torch.models.siren import SirenStack, positions, siren_apply
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops.fastmath import resolve_sin
    from nerf_attention_tpu_torch.tools.measure_decode import MEDIUM

    def hold(what, got, want, exact=None):
        torch.cuda.synchronize()
        if want.dtype == torch.bfloat16:
            return check_bf16(what, got, want)
        return check_fp64(what, got, want, exact()) if exact else check_close(what, got, want, **DECODE_TOL)

    with uncounted():
        for _, call, got in quality:
            stack = SirenStack.from_params([(w[None], b[None]) for w, b in call["params"]])
            omega, s, sine, dtype = call["omega"], call["seq_len"], call["sin_impl"], call["compute_dtype"]
            exact = lambda: siren_apply([(w.double(), b.double()) for w, b in call["params"]], omega,
                                        positions(s, device=dev).double(), sin=resolve_sin(sine))
            err["siren_decode"] = max(err["siren_decode"], hold(
                f"siren_decode medium S={s} {sine} {str(dtype)[6:]} (measure_decode's trained quality net)", got,
                siren_cuda.siren_decode_plain(stack, omega, s, sin_impl=sine, compute_dtype=dtype)[0], exact))
        for _, call, _ in ladder:
            stack = SirenStack.from_params([(w[None], b[None]) for w, b in params_from_jax(call["params"], dev)])
            kw = dict(sin_impl=call["sin_impl"], fm_mult=call["fm_mult"], compute_dtype=call["compute_dtype"])
            omega, s = call["omega"], call["seq_len"]
            err["siren_decode"] = max(err["siren_decode"], hold(
                f"siren_decode medium S={s} {kw['sin_impl']} {str(kw['compute_dtype'])[6:]} (measure_decode's ladder)",
                siren_cuda.siren_decode(stack, omega, s, **kw), siren_cuda.siren_decode_plain(stack, omega, s, **kw)[0]))
        for _, call, _ in aggregate:
            stack, s = call["stack"], call["seq_len"]
            kw = dict(sin_impl=call["sin_impl"], fm_mult=call["fm_mult"], compute_dtype=call["compute_dtype"])
            entry = "siren_decode_batch" + (" (bf16)" if kw["compute_dtype"] == torch.bfloat16 else "")
            err[entry] = max(err[entry], hold(
                f"siren_decode_batch N={stack.n} medium S={s} {kw['sin_impl']} {str(kw['compute_dtype'])[6:]} "
                "(measure_decode's aggregate)", siren_cuda.siren_decode_batch(stack, MEDIUM.omega_0, s, **kw),
                siren_cuda.siren_decode_plain(stack, MEDIUM.omega_0, s, **kw)))
    print(f"  measure_decode's decodes held: {len(quality)} quality (2B), {len(ladder)} ladder rungs and modes (2B), "
          f"{len(aggregate)} aggregate modes (2C)")


def root_tools_on_the_card(dev, tmp: Path, check_train, plan_json: Path) -> tuple[dict, dict, dict]:
    """Phase 24: the ported root tools (nerf_attention_tpu_torch/tools) driven on the card in process, each at its
    defaults but for the printed cuts: the decode ladder and its quality delta, the training-step bench, the
    quantized sustain study, the FM and FINER studies, re-pricing, the three serving studies and the rollout timing at
    Llama-3.1-8B's widths, the prefill ladder at Llama-3.2-3B's, the sink figure and plot_study. Counters zeroed before
    each tool and its 2A, 2B and 2C launches asserted exactly; each fit_batch and trajectory fit held at its own shape
    (outside the counts). Returns (launches, errors against the plain versions, seconds per tool)."""
    import torch

    from nerf_attention_tpu_torch.experiments import aggregate_decode, incremental
    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren
    from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda
    from nerf_attention_tpu_torch.parallel import sweep
    from nerf_attention_tpu_torch.parallel.sweep import normalize_targets
    from nerf_attention_tpu_torch.synthetic import generate_synthetic_kv
    from nerf_attention_tpu_torch.tools import (finer_study, fm_siren_study, fm_spacing_study, measure_decode,
                                                measure_rollout, model_end_metric_study, plan_rollout_study,
                                                prefill_ladder, quantized_sustain_study, reprice_study,
                                                rollout_drift_study, serving_lifecycle_study, sink_study_figure,
                                                train_impl_bench)
    from nerf_attention_tpu_torch.types import CONFIGS_FULL
    from nerf_attention_tpu_torch.utils import plotting

    counts = {"siren_train_grads": (siren_train_cuda.launches, "siren_train_grads"),
              "siren_decode": (siren_cuda.launches, "siren_decode"),
              "siren_decode_batch": (siren_cuda.launches, "siren_decode_batch"),
              "siren_decode_batch (bf16)": (siren_cuda.bf16_launches, "siren_decode_batch")}
    launches = {name: 0 for name in counts}
    err = {"siren_train_grads": 0.0, "siren_decode_batch": 0.0, "siren_decode_batch (bf16)": 0.0, "siren_decode": 0.0}
    seconds = {}

    def run(tag: str, fn, want: dict, trajectories=None):
        """``fn`` with every counter zeroed before it and read after; the launches against ``want`` (zero where
        absent); its fit_batch calls and (``trajectories``: the module whose ``_fit_with_trajectory`` the tool
        calls) trajectory fits held at their shapes."""
        for c, key in counts.values():
            c[key] = 0
        siren_cuda.wgmma_launches["siren_decode_batch"] = 0
        fits, trajs = [], []
        t0 = time.perf_counter()
        with tally(sweep, "fit_batch_dispatch", fits), tally(trajectories or incremental, "_fit_with_trajectory",
                                                             trajs):
            out = fn()
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        got = {name: c[key] for name, (c, key) in counts.items()}
        # Every bf16 2C launch went through csrc/siren_decode_bf16.cu (measure_decode's aggregate: all of them).
        assert siren_cuda.wgmma_launches["siren_decode_batch"] == got["siren_decode_batch (bf16)"], (
            tag, siren_cuda.wgmma_launches, got)
        want = {name: want.get(name, 0) for name in counts}
        print(f"  {tag}: {seconds[tag]:.1f}s; launches {got}", flush=True)
        assert got == want, (tag, got, want)
        hold_fits(tag, fits, dev, check_train, err)
        hold_trajectories(tag, trajs, dev, check_train, err)
        for name, n in got.items():
            launches[name] += n
        return out

    e = TOOL_EPOCHS
    # measure_decode: the quality fits (N=2, 2A) and their final evaluation (2C), 2B in three modes for each of
    # key and value; the ladder, 1 + samples x 200 launches of 2B per mode and S; the 512-net aggregate, 1 + 5 x 10
    # launches of 2C per mode (fp32 exact, bf16, fp32 fast).
    ladder = measure_decode.LADDER
    per_mode = 1 + DECODE_SAMPLES * 200
    print(f"  measure_decode: its defaults (ladder {'/'.join(map(str, ladder))}, {DECODE_SAMPLES} samples, quality at "
          f"S={SEQ_LEN} on layer 16 of the {NUM_LAYERS}-layer, {NUM_HEADS}-head cache, the 512-net aggregate); cut: "
          f"epochs {e} of 2000")
    quality, rungs, agg_calls = [], [], []

    def decode_tool():
        with tally(measure_decode, "siren_decode", quality), tally(measure_decode, "time_siren_forward_ms", rungs), \
                tally(aggregate_decode, "_time_batched_decode_ms", agg_calls):
            return measure_decode.main(["--out", str(tmp / "decode"), "--epochs", str(e)])

    dec = run("measure_decode", decode_tool,
              {"siren_train_grads": e, "siren_decode_batch": 1 + 3 * 51, "siren_decode_batch (bf16)": 51,
               "siren_decode": 6 + 3 * len(ladder) * per_mode})
    assert (len(quality), len(rungs), len(agg_calls)) == (6, 3 * len(ladder), 3), (len(quality), len(rungs))
    hold_measure_decode(quality, rungs, agg_calls, dev, err)
    for row in dec["ladder"]:
        for key in ("siren_fp32_ms", "siren_bf16_ms", "siren_fastsin_ms", "hbm_read_ms"):
            assert row[key]["n"] == DECODE_SAMPLES and 0 < row[key]["q25"] <= row[key]["median"] <= row[key]["q75"]
        print(f"    S={row['seq_len']}: 2B fp32 {row['siren_fp32_ms']['median']:.4f} ms, bf16 "
              f"{row['siren_bf16_ms']['median']:.4f}, fast sine {row['siren_fastsin_ms']['median']:.4f} "
              f"[{row['siren_fastsin_ms']['q25']:.4f}, {row['siren_fastsin_ms']['q75']:.4f}]; read "
              f"{row['hbm_read_ms']['median']:.5f} ms")
    for kv in ("key", "value"):
        q = dec["quality_at_headline"][kv]
        assert all(-1 <= q[k] <= 1 for k in ("fp32", "bf16", "fp32_fastsin")), q
        print(f"    quality {kv}: CosSim fp32 {q['fp32']:.6f}, bf16 {q['bf16']:.6f} (delta {q['delta']:.6f}), fast "
              f"sine {q['fp32_fastsin']:.6f} (delta {q['delta_fastsin']:.7f})")
    agg = json.loads((tmp / "decode" / "aggregate_decode.json").read_text())
    assert agg["num_networks"] == 512 and agg["backend"] == "cuda"
    print(f"    aggregate (512 nets, S={agg['seq_len']}): 2C fp32 {agg['siren_aggregate_ms']:.4f} ms, bf16 "
          f"{agg['siren_aggregate_bf16_ms']:.4f}, fast {agg['siren_aggregate_fastsin_ms']:.4f}; stream read "
          f"{agg['hbm_measured_aggregate_ms']:.4f} ms")

    # train_impl_bench: all 7 configs at N=40, S=2048, D=128; the plain leg (autograd) launches nothing, the cuda
    # leg 2A once an epoch: 5 n1 epochs a round (n1, then 4 n1), a warm-up round and `samples` rounds.
    b = TRAIN_BENCH
    print(f"  train_impl_bench: {len(CONFIGS_FULL)} configs, N={N_FITS}, S={SEQ_LEN}, D={HEAD_DIM}, plain:fast and "
          f"cuda:fast; cut: {b['n1']} and {4 * b['n1']} epochs a replicate (of 200 and 800), {b['samples']} "
          "replicates (of 5)")
    bench = run("train_impl_bench", lambda: train_impl_bench.main(
        ["--out", str(tmp / "train_impl.json"), "--n1", str(b["n1"]), "--samples", str(b["samples"])]),
        {"siren_train_grads": len(CONFIGS_FULL) * 5 * b["n1"] * (1 + b["samples"])})
    targets = torch.from_numpy(np.random.default_rng(0).standard_normal((N_FITS, SEQ_LEN, HEAD_DIM))
                               .astype(np.float32)).to(dev)
    tn = normalize_targets(targets)[0].contiguous()
    with uncounted():
        for config in CONFIGS_FULL:  # 2A at the bench's shape and targets, from the params its runner draws
            cpu = SirenStack.from_params(init_siren(config, HEAD_DIM, generator=torch.Generator().manual_seed(0),
                                                    n=N_FITS))
            err["siren_train_grads"] = max(err["siren_train_grads"], check_train(
                SirenStack(cpu.flat.to(dev), cpu.dims), tn, f"siren_train_grads {config.name} N={N_FITS} "
                f"(train_impl_bench)", TRAIN_TOL["fast"], omega=config.omega_0, sin_impl="fast"))
    for row in bench["results"]:
        plain, cuda = row["plain_fast_ms_per_epoch"], row["cuda_fast_ms_per_epoch"]
        print(f"    {row['config']}: an epoch plain {plain['median']:.4f} ms [{plain['q25']:.4f}, {plain['q75']:.4f}], "
              f"2A {cuda['median']:.4f} ms [{cuda['q25']:.4f}, {cuda['q75']:.4f}] "
              f"({plain['median'] / cuda['median']:.2f}x)")

    # The hard-mode caches of the storage and quality studies, from the port's generator.
    hard = tmp / "hard_kv"
    generate_synthetic_kv(seq_len=SEQ_LEN, num_layers=NUM_LAYERS, num_kv_heads=NUM_HEADS, head_dim=HEAD_DIM,
                          output_dir=hard, verbose=False, layer_indices=HARD_LAYERS, values_mode="hard")
    grown = tmp / "sustain_kv"
    generate_synthetic_kv(seq_len=SUSTAIN_LEN, num_layers=NUM_LAYERS, num_kv_heads=NUM_HEADS, head_dim=HEAD_DIM,
                          output_dir=grown, verbose=False, layer_indices=[8], values_mode="hard")

    # quantized_sustain_study: layer 8's 2 heads (N=4), 2048 -> 2304, int4_g128: the master and the control fits
    # (2A and a 2C trajectory point each epoch), QAT (2A), three warm fits (2A and 2C each epoch).
    print(f"  quantized_sustain_study: the hard cache at S={SUSTAIN_LEN}, layer 8, 2 heads, 2048 -> 2304, int4_g128; "
          f"cuts: epochs {e} of 2000, warm epochs {TOOL_WARM} of 1000, QAT epochs {TOOL_QAT} of 300")
    sus = run("quantized_sustain_study", lambda: quantized_sustain_study.main(
        ["--kv_dir", str(grown), "--out", str(tmp / "sustain.json"), "--epochs_full", str(e), "--warm_epochs",
         str(TOOL_WARM), "--qat_epochs", str(TOOL_QAT)]),
        {"siren_train_grads": 2 * e + TOOL_QAT + 3 * TOOL_WARM, "siren_decode_batch": 2 * e + 3 * TOOL_WARM},
        trajectories=quantized_sustain_study)
    assert set(sus["starts"]) == {"master", "stored", "stored_qat"} and sus["n_tensors"] == 4
    print("    " + "; ".join(f"{k} {r['start_cosine']:.4f} -> {r['final_cosine']:.4f} (parity at "
                             f"{r['epochs_to_parity']})" for k, r in sus["starts"].items())
          + f"; scratch {sus['scratch_final_cosine']:.4f}")

    # The FM and FINER studies on the hard cache: 5 sweep layers x 4 heads (N=20) each of K and V; FINER on layer 8's
    # first 4 value heads.
    print(f"  fm_siren_study, fm_spacing_study, finer_study: the hard cache ({NUM_LAYERS}-layer metadata, {NUM_HEADS} "
          f"KV heads, S={SEQ_LEN}, D={HEAD_DIM}), medium nets; cut: epochs {e} of 2000 ({FM_SPACING_EPOCHS} for "
          "fm_spacing_study)")
    fm = run("fm_siren_study", lambda: fm_siren_study.main(
        ["--kv_dir", str(hard), "--out", str(tmp / "fm_siren.json"), "--epochs", str(e)]),
        {"siren_train_grads": 2 * 4 * e, "siren_decode_batch": 2 * 4})
    sp = run("fm_spacing_study", lambda: fm_spacing_study.main(
        ["--kv_dir", str(hard), "--out", str(tmp / "fm_spacing.json"), "--epochs", str(FM_SPACING_EPOCHS)]),
        {"siren_train_grads": 2 * 3 * FM_SPACING_EPOCHS, "siren_decode_batch": 2 * 3})
    fi = run("finer_study", lambda: finer_study.main(
        ["--kv_dir", str(hard), "--out", str(tmp / "finer.json"), "--epochs", str(e)]),
        {"siren_train_grads": 2 * e, "siren_decode_batch": 2})
    for name, payload in (("fm_siren", fm), ("fm_spacing", sp)):
        v = payload["results"]["value"]
        print(f"    {name}: values " + ", ".join(f"{k} {r['cosine_mean']:.4f}" for k, r in v.items()))
        assert all(-1 <= r["cosine_mean"] <= 1 and r["n_fits"] == 20 for r in v.values())
    print("    finer: " + ", ".join(f"{k} {r['value_cosine_mean']:.4f}" for k, r in fi["variants"].items())
          + f"; {fi['storage']['variant']} stored " + ", ".join(f"{k} {c:.4f}" for k, c in fi["storage"].items()
                                                                if k != "variant"))

    # reprice_study: numpy on the host, over the committed artifact pair.
    rep = run("reprice_study", lambda: reprice_study.main(["--out", str(tmp / "reprice.json")]), {})
    assert rep["n_units"] == 32 and [r["n_probes"] for r in rep["rows"]] == [0, 2, 3, 4, 6, 8, 12, 16]

    # The serving studies at Llama-3.1-8B's widths, weights drawn on the card. Per gain one fit_batch of the
    # 2 x layers x 8 KV-head slices (2A, its final 2C), then 2C per reconstruction.
    weights = lambda config, seed: draw_study_llama(config, seed, dev)
    print(f"  serving studies and measure_rollout at Llama-3.1-8B's widths (hidden 4096, 32 query / 8 KV heads, "
          f"head_dim 128, FFN 14336, llama3 rope), random fp32 weights drawn on the card; cuts: "
          f"{'; '.join(TOOL_8B_CUTS)}, epochs {e} of 2000, absorb epochs {TOOL_ABSORB} of 500")
    gains = model_end_metric_study.DEFAULT_GAINS
    schemes = model_end_metric_study.DEFAULT_SCHEMES
    end = run("model_end_metric_study", lambda: model_end_metric_study.run_study(
        tmp / "end_metric", epochs=e, layers=SERVE_LAYERS, llama_config=TOOL_8B, reduced=TOOL_8B_CUTS, device=dev,
        weights=weights), {"siren_train_grads": len(gains) * e, "siren_decode_batch": len(gains) * (1 + len(schemes))})
    for row in end["gains"]:
        print(f"    end metric gain {row['gain']:g}: entropy {row['attn_entropy_nats']['mean']:.3f} nats; "
              + ", ".join(f"{s} full {p['full']['output_cosine_mean']:.5f}" for s, p in row["payloads"].items()))
    drift = run("rollout_drift_study", lambda: rollout_drift_study.run_study(
        tmp / "drift", epochs=e, layers=SERVE_LAYERS, llama_config=TOOL_8B, reduced=TOOL_8B_CUTS, device=dev,
        weights=weights), {"siren_train_grads": 3 * e, "siren_decode_batch": 3 * 2})
    for row in drift["gains"]:
        sm = row["summary"]
        print(f"    drift gain {row['gain']:g}: drift {sm['drift_first_quarter_mean']:.5f} -> "
              f"{sm['drift_last_quarter_mean']:.5f}, control {sm['control_last_quarter_mean']:.5f}")
    cycles, n_gains = 4, len(serving_lifecycle_study.DEFAULT_GAINS)
    life = run("serving_lifecycle_study", lambda: serving_lifecycle_study.run_study(
        tmp / "lifecycle", epochs=e, warm_epochs=TOOL_ABSORB, layers=SERVE_LAYERS, llama_config=TOOL_8B,
        reduced=TOOL_8B_CUTS, device=dev, weights=weights),
        {"siren_train_grads": n_gains * (e + cycles * TOOL_ABSORB),
         "siren_decode_batch": n_gains * (e + cycles * (2 + TOOL_ABSORB))}, trajectories=serving_lifecycle_study)
    for row in life["gains"]:
        print(f"    lifecycle gain {row['gain']:g}: rollout cosine "
              + " ".join(f"{c['rollout_output_cosine_mean']:.4f}" for c in row["cycles"]) + "; first region "
              + " ".join(f"{c['recon_vs_true_cosine_first_region']:.4f}" for c in row["cycles"]))
    roll = run("measure_rollout", lambda: measure_rollout.run_measure(
        tmp / "rollout", layers=SERVE_LAYERS, llama_config=TOOL_8B, reduced=TOOL_8B_CUTS, device=dev, weights=weights),
        {})
    print(f"    rollout: loop {roll['per_token_ms_loop']:.3f} ms a token, one rollout call "
          f"{roll['per_token_ms_scan']:.3f} ms a token ({roll['speedup']:.2f}x)")
    for payload in (end, drift, life, roll):
        assert payload["reduced"] == TOOL_8B_CUTS and payload["llama_config"]["hidden_size"] == 4096

    # prefill_ladder at Llama-3.2-3B's widths, bf16 weights drawn on the card.
    print(f"  prefill_ladder: Llama-3.2-3B's geometry, S 2048-32768, 3 reps, bf16 weights drawn on the card; cut: "
          f"layers {PREFILL_LAYERS} of 28")
    pre = run("prefill_ladder", lambda: prefill_ladder.run_ladder(
        tmp / "prefill", layers=PREFILL_LAYERS, device=dev,
        weights=lambda config, seed: draw_study_llama(config, seed, dev, torch.bfloat16)), {})
    assert pre["reduced"] == [f"layers {PREFILL_LAYERS} of 28"] and len(pre["ladder"]) == 5, pre["reduced"]
    for row in pre["ladder"]:
        assert "error" not in row, row
        print(f"    S={row['seq_len']}: {row['median_s'] * 1e3:.2f} ms, {row['tokens_per_s']:.0f} tokens/s, "
              f"{row['tflops']:.1f} TFLOP/s ({100 * row['mfu_vs_h100_bf16_peak']:.1f} % of the bf16 peak), peak "
              f"memory {row['memory']['peak_bytes_in_use'] / 2**30:.2f} GiB")

    # The figures: drawn where matplotlib imports, named as not drawn here; their JSON written.
    drawn_before = len(plotting.not_drawn)
    run("sink_study_figure", lambda: sink_study_figure.main(["--out", str(tmp / "sinks" / "summary.png")]), {})
    assert (tmp / "sinks" / "summary.json").is_file()
    if plan_json.is_file():
        run("plot_study", lambda: plan_rollout_study.plot_study(json.loads(plan_json.read_text()),
                                                                plan_json.with_suffix(".png")), {})
    print(f"  figures not drawn here: {plotting.not_drawn[drawn_before:] or 'none'}")
    return launches, err, seconds


def check_pt_checkpoints(fits: Path) -> None:
    """The study's fit stage wrote the reference's ``*_model.pt`` beside each medium ``.npz``, as the JAX study
    does: N_FITS of each, the same stems, each .pt loading to its .npz twin's params, stats and metrics bit for bit."""
    from nerf_attention_tpu_torch.io import checkpoint

    npz, pt = (sorted(fits.glob(f"*_model.{suffix}")) for suffix in ("npz", "pt"))
    assert len(npz) == len(pt) == N_FITS and [p.stem for p in npz] == [p.stem for p in pt], (len(npz), len(pt))
    for a, b in zip(npz, pt):
        native, ref = checkpoint.load_siren_checkpoint(a), checkpoint.load_siren_checkpoint(b)
        assert ref["metrics"] == native["metrics"] and ref["config"] == native["config"], b
        assert all(np.array_equal(x, y) for pa, pb in zip(native["params"], ref["params"]) for x, y in zip(pa, pb))
        assert all(np.array_equal(np.reshape(native[k], (1, -1)), ref[k]) for k in ("target_mean", "target_std"))
    print(f"  {len(pt)} reference-format *_model.pt beside the {len(npz)} .npz, each equal to its twin bit for bit")


def mesh_counters() -> dict:
    """Phase 25's launch counters by the kernels' JSON names, as (counts, key): a base name counts every launch of
    its wrapper, ``(bf16)`` those in the bf16 mode, ``(wgmma)`` those of the bf16 mode's Hopper kernel."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda, siren_cuda, siren_quant_cuda, siren_train_cuda

    out = {"siren_train_grads": (siren_train_cuda.launches, "siren_train_grads")}
    wrappers = ((siren_cuda, ["siren_decode_batch"]), (siren_attention_cuda, ["siren_attention_decode_fused"]),
                (siren_quant_cuda, ["siren_decode_batch_quant", "siren_attention_decode_quant"]))
    for module, names in wrappers:
        for name in names:
            out[name] = (module.launches, name)
            out[f"{name} (bf16)"] = (module.bf16_launches, name)
            out[f"{name} (wgmma)"] = (module.wgmma_launches, name)
    return out


def draw_sp_params(config, dev, seed: int) -> dict:
    """The port's parameters of a Llama ``config`` (``layer_shapes``), bf16, drawn on the card from
    ``torch.Generator(seed)``: projections and the embedding N(0, 0.02), norms 1 + N(0, 0.1), zero biases. Every
    rank of a mesh draws the same numbers on its card."""
    import torch

    from nerf_attention_tpu_torch.models.llama import layer_shapes

    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(name, shape):
        if name.endswith("bias"):
            return torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        x = torch.randn(shape, generator=g, device=dev)
        return (1 + 0.1 * x if "norm" in name else 0.02 * x).to(torch.bfloat16)

    layers = [{name: draw(name, shape) for name, shape in layer_shapes(config).items()}
              for _ in range(config.num_hidden_layers)]
    return {"embed": draw("embed", (config.vocab_size, config.hidden_size)), "layers": layers}


def mesh_compare(name: str, got, want, tol) -> dict:
    """A sharded output (or tuple of outputs) against the unsharded kernel's: bit for bit or not, and within the
    unsharded tolerance ``tol`` (``None``: BF16_ULPS bf16 ulps of each output's largest |value|)."""
    import torch

    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max((g.float() - w.float()).abs().max().item() for g, w in pairs)
    for g, w in pairs:
        if tol is None:
            limit = BF16_ULPS * 2.0**-8 * w.float().abs().max().item()
            assert (g.float() - w.float()).abs().max().item() <= limit, (name, err, limit)
        else:
            torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{name}: {m}")
    return {"max_abs_err": err, "bit_for_bit": all(torch.equal(g, w) for g, w in pairs)}


@contextlib.contextmanager
def sweep_batches():
    """Inside the block, each architecture group's (losses, cosine_mean) of ``fit_kv_cache``, by config name."""
    from nerf_attention_tpu_torch import fit as fit_cli

    batches, inner = {}, fit_cli.fit_batch

    def recording(targets, config, **kw):
        out = inner(targets, config, **kw)
        batches[config.name] = (out.losses, out.cosine_mean)
        return out

    fit_cli.fit_batch = recording
    try:
        yield batches
    finally:
        fit_cli.fit_batch = inner


def same_on_every_rank(x, mesh) -> bool:
    """Whether every rank of the mesh holds ``x`` bit for bit as rank 0 does."""
    import torch

    from nerf_attention_tpu_torch.parallel.mesh import gather_rows

    parts = gather_rows(x.reshape(1, -1), mesh)
    return all(torch.equal(parts[0], part) for part in parts)


def tp_case(mesh, config, params, seq: int, steps: int, seed: int, wall_ms, timed) -> dict:
    """One Llama configuration under tensor parallelism on this rank: the prefill of ``seq`` tokens, the decode step
    at ``seq`` over the rank's heads of a buffer of ``seq + steps`` rows holding the prefill, and a ``steps``-token
    rollout over the prefill's last ``steps`` rows, from the rank's shard of the buffers; each first call with every
    sum checked to come out the same bits on every rank, its collectives counted, then timed (the prefill and the
    rollout once more, the step as ``wall_ms`` times it; each call's ms over its tokens). Rank 0 runs the
    unsharded calls on the same weights and inputs alone on its card and holds the TP outputs to them: bit for bit in
    a world of one, else K/V within FAMILY_BF16_REL of the largest |K|, |V| and cosine 0.999 and h within cosine
    TP_H_COSINE; and, at SP_LAYERS layers, the rollout's rows to the prefill's within the K/V bars."""
    import torch

    from nerf_attention_tpu_torch.models import llama
    from nerf_attention_tpu_torch.parallel import mesh as pm

    world, lead = mesh.size(), mesh.get_local_rank() == 0
    ids = np.random.default_rng(seed).integers(0, config.vocab_size, seq + 1)
    start = seq - steps
    sharded = llama.shard_llama_params(params, mesh, config=config)
    checks, inner = [], llama.all_reduce_sum

    def checked(x, m):
        out = inner(x, m)
        checks.append(same_on_every_rank(out, mesh))
        return out

    def run_tp():
        """The prefill's K/V, the buffers holding them, the step's and the rollout's outputs, under TP."""
        keys, values = llama.llama_prefill_kv(config, sharded, ids[:seq])
        buffers = [torch.cat([x, x.new_zeros(*x.shape[:2], steps, x.shape[3])], dim=2) for x in (keys, values)]
        shards = [llama.shard_kv_heads(b, sharded["tp"]) for b in buffers]
        step = llama.llama_decode_step(config, sharded, int(ids[seq]), seq, *shards)
        rows = [torch.where(torch.arange(seq + steps, device=b.device)[:, None] < start, b, 0) for b in buffers]
        rollout = llama.llama_decode_rollout(config, sharded, ids[start:seq], start,
                                             *[llama.shard_kv_heads(r, sharded["tp"]) for r in rows])
        return (keys, values), buffers, step, rollout

    before = dict(pm.collectives)
    llama.all_reduce_sum = checked
    try:
        (keys, values), buffers, step, rollout = run_tp()
        same = all(checks) and same_on_every_rank(step[0], mesh) and same_on_every_rank(rollout[0], mesh)
    finally:
        llama.all_reduce_sum = inner
    collectives = {k: pm.collectives[k] - before.get(k, 0) for k in ("all_reduce_sum", "gather_rows")}
    collectives["gather_rows"] -= len(checks) + 2  # the checks' own gathers
    out = {"same_bits": same, "collectives": collectives, "reduces_checked": len(checks)}
    out["ms"] = {"prefill": timed(lambda: llama.llama_prefill_kv(config, sharded, ids[:seq]))[1] / seq}
    shards = [llama.shard_kv_heads(b, sharded["tp"]) for b in buffers]  # read only (in a world of one, `buffers`)
    out["ms"]["step"] = wall_ms(lambda: llama.llama_decode_step(config, sharded, int(ids[seq]), seq, *shards), 5)
    written = [llama.shard_kv_heads(b.clone(), sharded["tp"]) for b in buffers]  # each call rewrites the same rows
    out["ms"]["rollout"] = timed(lambda: llama.llama_decode_rollout(config, sharded, ids[start:seq], start,
                                                                    *written))[1] / steps
    del shards, written
    if not lead:
        return out

    # ---- rank 0: the unsharded calls on the same weights and inputs, then the comparisons ----
    want_kv = llama.llama_prefill_kv(config, params, ids[:seq])
    want_step = llama.llama_decode_step(config, params, int(ids[seq]), seq, *buffers)
    rows = [torch.where(torch.arange(seq + steps, device=b.device)[:, None] < start, b, 0) for b in buffers]
    want_roll = llama.llama_decode_rollout(config, params, ids[start:seq], start, *[r.clone() for r in rows])
    out["unsharded_ms"] = {
        "prefill": timed(lambda: llama.llama_prefill_kv(config, params, ids[:seq]))[1] / seq,
        "step": wall_ms(lambda: llama.llama_decode_step(config, params, int(ids[seq]), seq, *buffers), 5),
        "rollout": timed(lambda: llama.llama_decode_rollout(config, params, ids[start:seq], start, *rows))[1]
        / steps}
    pairs = {"keys": (keys, want_kv[0]), "values": (values, want_kv[1]), "step h": (step[0], want_step[0]),
             "step k_new": (step[1][0], want_step[1][0]), "step v_new": (step[1][1], want_step[1][1]),
             "step entropy": (step[2], want_step[2]), "rollout h": (rollout[0], want_roll[0]),
             "rollout keys": (rollout[1][0], want_roll[1][0]), "rollout values": (rollout[1][1], want_roll[1][1]),
             "rollout entropy": (rollout[3], want_roll[3])}
    out["exact"] = {name: bool(torch.equal(g, w)) for name, (g, w) in pairs.items()}
    out["max_abs_err"] = max((g.float() - w.float()).abs().max().item() for g, w in pairs.values())
    if world == 1:
        assert all(out["exact"].values()), ("a world of one differs from the unsharded calls", out["exact"])
    else:
        for name in ("keys", "values", "step k_new", "step v_new"):
            g, w = pairs[name]
            share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
            out[f"{name} share"], out[f"{name} cosine"] = share, cosine(g, w)
            assert share <= FAMILY_BF16_REL and out[f"{name} cosine"] >= 0.999, (name, share, out[f"{name} cosine"])
        for name in ("step h", "rollout h"):
            out[f"{name} cosine"] = cosine(*pairs[name])
            assert out[f"{name} cosine"] >= TP_H_COSINE, (name, out[f"{name} cosine"])
    # The rollout refills the prefill's last rows: within the K/V bars at SP_LAYERS layers, where those bars were set
    # (phase 21); deeper, the step's and the prefill's bf16 roundings compound layer on layer, and the gap is reported.
    for i, x in enumerate((keys, values)):
        g, w = rollout[1][i][:, :, start:seq], x[:, :, start:seq]
        share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        out[f"refill {i} share"], out[f"refill {i} cosine"] = share, cosine(g, w)
        if config.num_hidden_layers <= SP_LAYERS:
            assert share <= FAMILY_BF16_REL and out[f"refill {i} cosine"] >= 0.999, ("refill", i, share)
    return out


def tp_rank_checks(mesh, dev, wall_ms, timed, counts) -> dict:
    """Phase 25's tensor-parallel cases on this rank (``tp_case``): Llama-3.1-8B's widths (all 32 layers on NCCL
    ranks, SP_LAYERS on Gloo ones) and GPT-OSS-20B's (phase 21's cut), bf16, weights drawn on the card; with this
    rank's kernel launches over them (none: the TP forward runs plain matmuls)."""
    import torch
    import torch.distributed as dist

    from nerf_attention_tpu_torch.models import llama

    layers = TP_NCCL_LAYERS if dist.get_backend(mesh.get_group()) == "nccl" else SP_LAYERS
    before, out = counts(), {}
    config = llama.LlamaConfig.from_hf_dict({**LLAMA_31_8B, "num_hidden_layers": layers})
    params = draw_sp_params(config, dev, seed=43)
    out["llama"] = tp_case(mesh, config, params, SP_SEQ, TP_ROLLOUT, 44, wall_ms, timed)
    out["llama"]["layers"] = layers
    del params
    torch.cuda.empty_cache()
    config = llama.LlamaConfig.from_hf_dict(GPT_OSS_20B)
    t = draw_gpt_oss(dev, seed=45)
    params = {"embed": t["model.embed_tokens.weight"],
              "layers": [{k: v.contiguous() for k, v in gpt_oss_leaves(t, i).items()}
                         for i in range(config.num_hidden_layers)]}
    del t
    out["gpt_oss"] = tp_case(mesh, config, params, FAMILY_SEQ, GPT_OSS_ROLLOUT, 46, wall_ms, timed)
    out["gpt_oss"]["layers"] = config.num_hidden_layers
    del params
    torch.cuda.empty_cache()
    now = counts()
    out["launches"] = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    return out


def mesh_rank_checks(mesh, kv_dir: str, out_dir: str) -> dict:
    """Phase 25 on one rank of a fit mesh: the sweep through ``fit_kv_cache(mesh=)``, kernels 2C-2F sharded and
    the SP prefill, each against the unsharded kernel (or prefill) that rank 0 runs alone on its card; every
    rank's launches in each part. Rank 0 returns the results."""
    import torch
    import torch.distributed as dist

    from nerf_attention_tpu_torch import fit as fit_cli
    from nerf_attention_tpu_torch.models import llama
    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_cuda
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.parallel.mesh import barrier, mesh_device
    from nerf_attention_tpu_torch.tools import measure_attention_decode
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME
    from nerf_attention_tpu_torch.utils.device import pin_fp32_matmul

    pin_fp32_matmul()
    rank, world, dev = mesh.get_local_rank(), mesh.size(), mesh_device(mesh)
    backend, lead = dist.get_backend(mesh.get_group()), mesh.get_local_rank() == 0
    counters = mesh_counters()

    def counts():
        return {name: c[key] for name, (c, key) in counters.items()}

    def since(before):
        now = counts()
        return {k: now[k] - before[k] for k in now if now[k] != before[k]}

    def timed(fn):
        """fn()'s result and its wall ms, one call, between two synchronizes."""
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    def wall_ms(fn, reps):
        """The median host time of ``reps`` calls after a warm-up, each between two synchronizes (the host is
        shared, so one slow call must not move the figure)."""
        fn()
        return float(np.median([timed(fn)[1] for _ in range(reps)]))

    # ---- the sweep: fit --mesh's function, each group's losses and CosSim recorded ----
    before, t0 = counts(), time.perf_counter()
    with sweep_batches() as batches:
        fit_cli.fit_kv_cache(Path(kv_dir), Path(out_dir), epochs=STUDY_EPOCHS, mesh=mesh, verbose=False)
    sweep = {"seconds": time.perf_counter() - t0, "launches": since(before), "batches": batches if lead else None}

    # ---- kernels 2C-2F: the global operands drawn on the host; every rank holds them on its card, and puts its
    # own nets there once as its resident shard (shard_stack / shard_packed: a copy, or its nets packed alone) ----
    medium, small = CONFIGS_BY_NAME["medium"], CONFIGS_BY_NAME["small"]
    gen = lambda seed: torch.Generator().manual_seed(seed)
    nets = SirenStack.from_params(init_siren(medium, HEAD_DIM, generator=gen(31), n=MESH_DECODE_NETS))
    small_nets = init_siren(small, HEAD_DIM, generator=gen(32), n=PLAN_NETS)
    k_stack, v_stack, stats, q = measure_attention_decode.attention_inputs(medium, NUM_HEADS, 1, HEAD_DIM, gen(33),
                                                                           "cpu")
    kv = (k_stack.params(), v_stack.params())
    nets_dev, k_dev, v_dev = (SirenStack(x.flat.to(dev), x.dims) for x in (nets, k_stack, v_stack))
    stats_dev, q_dev = [x.to(dev) for x in stats], q.to(dev)
    small_dev = [(w.to(dev), b.to(dev)) for w, b in small_nets]
    kv_dev = (k_dev.params(), v_dev.params())
    nets_shard, nets_ms = timed(lambda: siren_cuda.shard_stack(nets, mesh))
    kv_shards, kv_ms = timed(lambda: tuple(siren_cuda.shard_stack(x, mesh) for x in (k_stack, v_stack)))
    small_shard, small_ms = timed(lambda: sq.shard_packed(small_nets, MESH_QUANT_SCHEME, mesh))
    kv_payloads, kv_pack_ms = timed(lambda: tuple(sq.shard_packed(p, MESH_QUANT_SCHEME, mesh) for p in kv))
    if lead:  # the unsharded payloads, on rank 0's card only
        small_packed = sq.pack_resident_params(small_dev, MESH_QUANT_SCHEME)
        kv_packed = tuple(sq.pack_resident_params(p, MESH_QUANT_SCHEME) for p in kv_dev)
    omega, bf16 = medium.omega_0, torch.bfloat16
    cases = []  # (name, JSON entry, call on the resident shards, on the global operands, unsharded, tolerance,
    #             reps, ms the shards took to put on the card)
    for dtype, tol, mode in ((torch.float32, DECODE_TOL, "fp32"), (bf16, None, "bf16")):
        entry = "siren_decode_batch" if mode == "fp32" else "siren_decode_batch (bf16)"
        cases.append((f"2C N={MESH_DECODE_NETS} S={SEQ_LEN} exact {mode}", entry,
                      lambda d=dtype: siren_cuda.siren_decode_batch_sharded(nets_shard, omega, SEQ_LEN, mesh,
                                                                            compute_dtype=d),
                      lambda d=dtype: siren_cuda.siren_decode_batch_sharded(nets_dev, omega, SEQ_LEN, mesh,
                                                                            compute_dtype=d),
                      lambda d=dtype: siren_cuda.siren_decode_batch(nets_dev, omega, SEQ_LEN, compute_dtype=d),
                      tol, MESH_DECODE_REPS, nets_ms))
        for seq_len in MESH_ATTN_SEQS:
            kw = dict(sin_impl="fast", compute_dtype=dtype)
            cases.append((f"2D N={NUM_HEADS} S={seq_len} T=1 fast {mode}", "siren_attention_decode_fused"
                          + ("" if mode == "fp32" else " (bf16)"),
                          lambda kw=kw, s=seq_len: sa.siren_attention_decode_sharded(*kv_shards, *stats_dev, q_dev,
                                                                                     omega, s, mesh, **kw),
                          lambda kw=kw, s=seq_len: sa.siren_attention_decode_sharded(k_dev, v_dev, *stats_dev, q_dev,
                                                                                     omega, s, mesh, **kw),
                          lambda kw=kw, s=seq_len: sa.siren_attention_decode_fused(k_dev, v_dev, *stats_dev, q_dev,
                                                                                   omega, s, **kw),
                          ATTN_TOL if mode == "fp32" else None, MESH_REPS, kv_ms))
        kw = dict(sin_impl="fast", compute_dtype=dtype)
        cases.append((f"2E N={PLAN_NETS} small S={PLAN_SEQ_LEN} {MESH_QUANT_SCHEME} fast {mode}",
                      "siren_decode_batch_quant" + ("" if mode == "fp32" else " (bf16)"),
                      lambda kw=kw: sq.siren_decode_batch_quant_sharded(None, MESH_QUANT_SCHEME, small.omega_0,
                                                                        PLAN_SEQ_LEN, mesh, packed=small_shard, **kw),
                      lambda kw=kw: sq.siren_decode_batch_quant_sharded(small_dev, MESH_QUANT_SCHEME, small.omega_0,
                                                                        PLAN_SEQ_LEN, mesh, **kw),
                      lambda kw=kw: sq.siren_decode_batch_quant(None, MESH_QUANT_SCHEME, small.omega_0, PLAN_SEQ_LEN,
                                                                packed=small_packed, **kw),
                      DECODE_TOL if mode == "fp32" else None, MESH_REPS, small_ms))
        kw = dict(sin_impl="fast", return_stats=True, compute_dtype=dtype)
        cases.append((f"2F N={NUM_HEADS} S={SEQ_LEN} T=1 {MESH_QUANT_SCHEME} with (m, l) {mode}",
                      "siren_attention_decode_quant" + ("" if mode == "fp32" else " (bf16)"),
                      lambda kw=kw: sq.siren_attention_decode_quant_sharded(None, None, *stats_dev, q_dev,
                                                                            MESH_QUANT_SCHEME, omega, SEQ_LEN, mesh,
                                                                            packed=kv_payloads, **kw),
                      lambda kw=kw: sq.siren_attention_decode_quant_sharded(*kv_dev, *stats_dev, q_dev,
                                                                            MESH_QUANT_SCHEME, omega, SEQ_LEN, mesh,
                                                                            **kw),
                      lambda kw=kw: sq.siren_attention_decode_quant(None, None, *stats_dev, q_dev, MESH_QUANT_SCHEME,
                                                                    omega, SEQ_LEN, packed=kv_packed, **kw),
                      ATTN_TOL if mode == "fp32" else None, MESH_REPS, kv_pack_ms))
    results = []
    for name, entry, resident, from_global, unsharded, tol, reps, shard_ms in cases:
        want = unsharded_ms = None
        if lead:  # alone on the card: the other ranks wait at the barrier
            want = unsharded()
            unsharded_ms = wall_ms(unsharded, reps)
        barrier(mesh)
        before = counts()
        got = resident()
        ms = wall_ms(resident, reps)
        # The global operands: each rank cuts its rows on the card (2C, 2D) or packs its nets (2E, 2F) per call.
        again, global_ms = timed(from_global)
        same = all(torch.equal(a, b) for a, b in (zip(got, again) if isinstance(got, tuple) else [(got, again)]))
        assert same, f"{name}: the resident shards and the global operands gave different outputs"
        result = {"name": name, "entry": entry, "calls": reps + 3, "launches": since(before)}
        if lead:
            result.update(ms=ms, global_ms=global_ms, shard_ms=shard_ms, unsharded_ms=unsharded_ms,
                          **mesh_compare(name, got, want, tol))
        results.append(result)
        del got, again, want

    # ---- the SP prefill at Llama-3.1-8B's widths ----
    config = llama.LlamaConfig.from_hf_dict({**LLAMA_31_8B, "num_hidden_layers": SP_LAYERS})
    params = draw_sp_params(config, dev, seed=41)
    ids = np.random.default_rng(42).integers(0, config.vocab_size, SP_SEQ)
    sp = {}
    if lead:
        want = llama.llama_prefill_kv(config, params, ids)
        sp["single_ms"] = wall_ms(lambda: llama.llama_prefill_kv(config, params, ids), 2)
    barrier(mesh)
    got = llama.llama_prefill_kv_sp(config, params, ids, mesh)
    sp["ms"] = wall_ms(lambda: llama.llama_prefill_kv_sp(config, params, ids, mesh), 2)
    if lead:
        for which, g, w in (("keys", got[0], want[0]), ("values", got[1], want[1])):
            err = (g.float() - w.float()).abs().max().item()
            share, cos = err / w.float().abs().max().item(), cosine(g, w)
            sp[which] = {"max_abs_err": err, "share": share, "cosine": cos, "bit_for_bit": torch.equal(g, w),
                         "shape": tuple(g.shape)}
            assert g.shape == (SP_LAYERS, config.num_key_value_heads, SP_SEQ, config.head_dim), g.shape
            assert share <= FAMILY_BF16_REL and cos >= 0.999, ("sp prefill", which, share, cos)
    del params, got
    torch.cuda.empty_cache()

    # ---- Megatron tensor parallelism of the Llama ----
    t0 = time.perf_counter()
    tp = tp_rank_checks(mesh, dev, wall_ms, timed, counts)
    tp_seconds = time.perf_counter() - t0
    per_rank = [None] * world
    dist.all_gather_object(per_rank, {"rank": rank, "sweep": sweep["launches"],
                                      "cases": [r["launches"] for r in results],
                                      "tp": {"launches": tp["launches"], "seconds": tp_seconds,
                                             **{name: {k: tp[name][k] for k in ("same_bits", "collectives", "ms")}
                                                for name in ("llama", "gpt_oss")}}})
    return {"backend": backend, "world": world, "sweep": sweep, "cases": results, "sp": sp, "tp": tp,
            "per_rank": per_rank}


def mesh_on_the_card(dev, tmp: Path, kv_dir: Path) -> dict:
    """Phase 25: the unsharded sweep here, then each world of ranks (``mesh_rank_checks``) held to it; each rank's
    launches asserted. Returns the sharded launches summed over every rank of every world, by JSON entry."""
    import torch

    from nerf_attention_tpu_torch import fit as fit_cli
    from nerf_attention_tpu_torch.parallel.mesh import run_on_mesh

    t0 = time.perf_counter()
    with sweep_batches() as batches:
        fit_cli.fit_kv_cache(kv_dir, tmp / "mesh_single", epochs=STUDY_EPOCHS, device=dev, verbose=False)
    single_s = time.perf_counter() - t0
    single_records = json.loads((tmp / "mesh_single" / "fit_results.json").read_text())
    print(f"  the unsharded sweep ({len(single_records)} fits, {STUDY_EPOCHS} epochs) here: {single_s:.1f}s")
    torch.cuda.empty_cache()  # the ranks are other processes on the same card(s)

    cards = torch.cuda.device_count()
    worlds = [("cuda", cards)] + ([("cuda:0", 2)] if cards == 1 else [])
    totals = collections.Counter()
    for device, n in worlds:
        out_dir = tmp / f"mesh_fits_{device.replace(':', '')}_{n}"
        t0 = time.perf_counter()
        res = run_on_mesh(mesh_rank_checks, str(kv_dir), str(out_dir), world_size=n, device=device)
        tag = f"[world of {n} {res['backend']} rank(s) on {device}]"
        print(f"  {tag} ran in {time.perf_counter() - t0:.1f}s (the sweep {res['sweep']['seconds']:.1f}s)")

        # The sweep: each group's losses and CosSim, then every record, against the unsharded run.
        gaps = {"losses": 0.0, "cosine_mean": 0.0}
        exact = True
        for name, (losses, cos) in res["sweep"]["batches"].items():
            want_losses, want_cos = batches[name]
            np.testing.assert_allclose(losses, want_losses, **TRAIN_TOL["fast"]["loss"], err_msg=f"{tag} {name}")
            np.testing.assert_allclose(cos, want_cos, atol=2e-3, err_msg=f"{tag} {name}")
            gaps["losses"] = max(gaps["losses"], float(np.max(np.abs(losses - want_losses))))
            gaps["cosine_mean"] = max(gaps["cosine_mean"], float(np.max(np.abs(cos - want_cos))))
            exact &= bool(np.array_equal(losses, want_losses) and np.array_equal(cos, want_cos))
        records = json.loads((out_dir / "fit_results.json").read_text())
        assert [r["name"] for r in records] == [r["name"] for r in single_records]
        for r, w in zip(records, single_records):
            for key in ("final_cosine_mean", "final_cosine_min", "final_cosine_std"):
                assert abs(r[key] - w[key]) <= 2e-3, (tag, r["name"], key, r[key], w[key])
            assert {k: v for k, v in r.items() if not k.startswith(("final_", "train_time"))} == \
                   {k: v for k, v in w.items() if not k.startswith(("final_", "train_time"))}
        print(f"  {tag} sweep: {len(records)} fits in {len(res['sweep']['batches'])} groups, "
              f"{'bit for bit' if exact else 'not bit for bit'} against the unsharded run: largest gaps losses "
              f"{gaps['losses']:.3e} (rtol 1e-3, atol 1e-5), CosSim {gaps['cosine_mean']:.3e} (atol 2e-3); one "
              f"fit_results.json, every record's CosSim within 2e-3 and its other fields equal")

        for r in res["cases"]:
            print(f"  {tag} {r['name']}: sharded {r['ms']:.4f} ms a call from the resident shards (put on the card "
                  f"once in {r['shard_ms']:.4f} ms), {r['global_ms']:.4f} ms from the global operands on the card, "
                  f"unsharded {r['unsharded_ms']:.4f} ms; "
                  f"{'bit for bit' if r['bit_for_bit'] else 'not bit for bit'} (max_abs_err {r['max_abs_err']:.3e})")
        sp = res["sp"]
        print(f"  {tag} SP prefill, Llama-3.1-8B widths ({'; '.join(SP_CUTS)}), bf16, S={SP_SEQ}: {sp['ms']:.2f} ms "
              f"against the single-device prefill's {sp['single_ms']:.2f} ms; "
              + "; ".join(f"{w} {sp[w]['shape']} max_abs_err {sp[w]['max_abs_err']:.3e} ({sp[w]['share']:.2e} of "
                          f"the largest, limit {FAMILY_BF16_REL}), cosine {sp[w]['cosine']:.6f}, "
                          + ("bit for bit" if sp[w]["bit_for_bit"] else "not bit for bit") for w in ("keys", "values")))

        # Each rank's launches: the sweep's 7 groups of STUDY_EPOCHS 2A steps and one 2C evaluation; each case's
        # calls through its kernel (a bf16 call through its mode's Hopper kernel), and nothing else.
        groups = len(res["sweep"]["batches"])
        world_totals = collections.Counter()
        for r in res["per_rank"]:
            want = {"siren_train_grads": groups * STUDY_EPOCHS, "siren_decode_batch": groups}
            assert r["sweep"] == want, (tag, r["rank"], r["sweep"], want)
            world_totals.update(r["sweep"])
            for case, got in zip(res["cases"], r["cases"]):
                base = case["entry"].replace(" (bf16)", "")
                want = {base: case["calls"]}
                if case["entry"] != base:
                    want.update({case["entry"]: case["calls"], f"{base} (wgmma)": case["calls"]})
                assert got == want, (tag, r["rank"], case["name"], got, want)
                world_totals.update({k: v for k, v in got.items() if not k.endswith("(wgmma)")})
        print(f"  {tag} each rank's launches asserted; over its ranks: {dict(sorted(world_totals.items()))}")
        totals.update(world_totals)
        tp_on_the_card(tag, res)
    tp_extraction_on_the_card(dev, tmp)
    return dict(totals)


def tp_on_the_card(tag: str, res: dict) -> None:
    """Phase 25's tensor-parallel results of one world (``tp_rank_checks``), printed beside the card's name and
    power limit; each rank's sums the same bits on every rank, its collectives and (no) kernel launches asserted."""
    card = nvidia_smi_line()
    labels = {"llama": ("Llama-3.1-8B widths", SP_SEQ, TP_ROLLOUT, 2),
              "gpt_oss": ("GPT-OSS-20B widths", FAMILY_SEQ, GPT_OSS_ROLLOUT, 1)}
    for name, (label, seq, steps, sums) in labels.items():
        r = res["tp"][name]
        exact = all(r["exact"].values())
        ms, single = r["ms"], r["unsharded_ms"]
        bars = "; " + ", ".join(f"{k} {v:.6f}" for k, v in r.items() if k.endswith(("share", "cosine")))
        print(f"  {tag} TP {label} ({r['layers']} layers, vocabulary 4096, bf16; {card}): ms a token, TP against "
              f"unsharded: prefill S={seq} {ms['prefill']:.5f} / {single['prefill']:.5f}, decode step at {seq} "
              f"{ms['step']:.3f} / {single['step']:.3f}, {steps}-token rollout {ms['rollout']:.3f} / "
              f"{single['rollout']:.3f}; {'bit for bit' if exact else 'not bit for bit'} against the unsharded calls "
              f"(max_abs_err {r['max_abs_err']:.3e}){bars}; {r['reduces_checked']} sums, each the same bits on every "
              "rank")
        for rank in res["per_rank"]:
            got = rank["tp"][name]
            want = {"all_reduce_sum": r["layers"] * sums * (2 + steps), "gather_rows": 10}
            assert got["same_bits"] and got["collectives"] == want, (tag, rank["rank"], name, got, want)
    for rank in res["per_rank"]:
        assert rank["tp"]["launches"] == {}, (tag, rank["rank"], rank["tp"]["launches"])
        print(f"  {tag} rank {rank['rank']}: TP in {rank['tp']['seconds']:.1f}s, no kernel launch; collectives "
              + "; ".join(f"{name} {rank['tp'][name]['collectives']}" for name in labels))


def tp_extraction_on_the_card(dev, tmp: Path) -> None:
    """``extract --backend jax --mesh tp`` with one NCCL rank (a visible card) over a checkpoint at
    Llama-3.1-8B's widths (SP_LAYERS layers, bf16, the fixture tokenizer): every layer file and the metadata bit for
    bit the unsharded extraction's."""
    import shutil

    import torch

    from nerf_attention_tpu_torch import extract
    from nerf_attention_tpu_torch.io import kvstore

    repo = Path(__file__).resolve().parent
    ckpt = tmp / "llama_8b_tp"
    config = {**TEXT_CONFIG, "num_hidden_layers": SP_LAYERS}
    write_checkpoint(ckpt, config, draw_llama_8b(dev, seed=47, config=config))
    for name in TEXT_FILES:
        shutil.copy(repo / TEXT_TOKENIZER / name, ckpt / name)
    torch.cuda.empty_cache()
    argv = ["--backend", "jax", "--model", str(ckpt), "--seq_len", str(TEXT_SEQ)]
    single, tp = tmp / "tp_extract_single", tmp / "tp_extract_tp"
    seconds = {}
    for run, extra in (("unsharded", ["--output_dir", str(single)]), ("--mesh tp", ["--output_dir", str(tp),
                                                                                    "--mesh", "tp"])):
        t0 = time.perf_counter()
        extract.main([*argv, *extra])
        seconds[run] = time.perf_counter() - t0
    assert sorted(p.name for p in tp.iterdir()) == sorted(p.name for p in single.iterdir())
    meta = kvstore.load_metadata(single)
    assert kvstore.load_metadata(tp).to_dict() == meta.to_dict()
    for i in range(meta.num_layers):
        assert all(np.array_equal(a, b) for a, b in zip(kvstore.load_layer(tp, i), kvstore.load_layer(single, i))), i
    print(f"  extract --backend jax --mesh tp (one NCCL rank, {SP_LAYERS} layers at Llama-3.1-8B widths, "
          f"{meta.seq_len} ids): every layer file bit for bit the unsharded extraction's; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    shutil.rmtree(ckpt)


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

    from nerf_attention_tpu_torch import study, synthetic
    from nerf_attention_tpu_torch.experiments import __main__ as experiments_cli
    from nerf_attention_tpu_torch.experiments import attention_error, head_policy, incremental, quantized_params
    from nerf_attention_tpu_torch.io import kvstore
    from nerf_attention_tpu_torch.models import llama_hybrid
    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren, layer_dims
    from nerf_attention_tpu_torch.ops import (
        _build,
        kv_quant_cuda,
        mla_absorbed_cuda,
        mla_quant_cuda,
        qat,
        siren_attention_cuda,
        siren_cuda,
        siren_quant_cuda,
        siren_train_cuda,
    )
    from nerf_attention_tpu_torch.tools import measure_attention_decode, mla_decode_bench, plan_rollout_study
    from nerf_attention_tpu_torch.parallel.sweep import fit_batch, normalize_targets
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME, CONFIGS_FULL, SIRENConfig
    from nerf_attention_tpu_torch.utils import plotting
    from nerf_attention_tpu_torch.utils.device import pin_fp32_matmul
    from nerf_attention_tpu_torch.utils.timing import kernel_ms_per_call, per_launch_ms

    pin_fp32_matmul()
    dev = torch.device("cuda")

    # ---- 2. build: every library started at once; the study's awaited here, the others before phase 3 ----
    def build(name):
        t0 = time.perf_counter()
        if name == HOST_LIBRARY:
            _build.load_host_library(name)
        else:
            _build.load_library(name)
        return time.perf_counter() - t0

    def built(names):
        for name in names:
            took = builds[name].result()
            print(f"  {name}{' (g++, the host generator)' if name == HOST_LIBRARY else ''}: built and loaded in "
                  f"{took:.1f}s")
            for line in _build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line or "stack frame" in line:
                    print(f"    ptxas: {line.strip()}")

    pool = concurrent.futures.ThreadPoolExecutor(len(LIBRARIES) + 1)
    builds = {name: pool.submit(build, name) for name in (*LIBRARIES, HOST_LIBRARY)}
    pool.shutdown(wait=False)
    with phase("2 build"):
        built(STUDY_LIBRARIES)

    def stack_for(config, n, seed):
        gen = torch.Generator().manual_seed(seed)
        cpu = SirenStack.from_params(init_siren(config, HEAD_DIM, generator=gen, n=n))
        return SirenStack(cpu.flat.to(dev), cpu.dims)

    def median_ms(fn, reps):
        return float(np.median(per_launch_ms(fn, reps, 3, dev)))

    report = {}

    # The work directory of phases 4-25. Phases 4 and 5 run first, while the attention, MLA and KV-cache kernels
    # still compile; counts and snapshots are their own, so phase 3 after them changes none of theirs.
    workdir = contextlib.ExitStack()
    tmp = Path(workdir.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_")))
    study_root = tmp / "study"
    for counts in (siren_cuda.launches, siren_cuda.bf16_launches, siren_cuda.wgmma_launches,
                   siren_train_cuda.launches):
        for key in counts:
            counts[key] = 0
    plotting.not_drawn.clear()

    # ---- 4. the study, every stage on the card ----
    qat_calls, recon_calls, quant_calls, cache_calls = [], [], [], []
    attn_calls, attn_recon, hp_calls, hp_recon = [], [], [], []
    with phase("4 study"), counted(qat, "qat_finetune_checkpoints", qat_calls), \
            counted(quantized_params, "_reconstruct", recon_calls), \
            counted(quantized_params, "run_quantization_experiment", quant_calls), \
            counted(synthetic, "generate_synthetic_kv", cache_calls), \
            counted(attention_error, "run_attention_error_experiment", attn_calls), \
            counted(attention_error, "_reconstruct", attn_recon), \
            counted(head_policy, "run_head_policy_experiment", hp_calls), \
            counted(head_policy, "_reconstruct", hp_recon):
        print(f"  python -m nerf_attention_tpu_torch.study --root <tmp> --epochs {STUDY_EPOCHS} --compress "
              f"{STUDY_COMPRESS}: the synthetic reference recipe, {NUM_LAYERS}-layer metadata, {NUM_HEADS} KV "
              f"heads, S={SEQ_LEN}, D={HEAD_DIM}; the 280-fit sweep, the scaling ladder "
              f"{'/'.join(map(str, SCALING_LADDER))}, {len(PROMPTS)} prompts, the SVD grid, the {NUM_LAYERS}-layer "
              f"profile, the {NUM_LAYERS * NUM_HEADS * 2}-net aggregate decode, quantized storage ({N_FITS} "
              f"checkpoints x {len(QUANT_SCHEMES)} schemes, {QAT_EPOCHS} QAT epochs at N={N_FITS}), "
              f"compress at {STUDY_COMPRESS}; --attention: layers {'/'.join(map(str, ATTN_LAYERS))}, "
              f"{ATTN_HEADS} heads' K and V, medium nets, {ATTN_QUERIES} queries, gains "
              f"{'/'.join(f'{g:g}' for g in ATTN_GAINS)}; --serving: the hermetic {HP_LAYERS}-layer dense Llama "
              f"({HP_LAYERS * HP_KV} units, S=512, `small` nets, payloads {'/'.join(HP_PAYLOADS)}) and its plans")
        print(f"  cuts: {'; '.join(STUDY_CUTS)}")
        t0 = time.perf_counter()
        stage_seconds = study.main(["--root", str(study_root), "--epochs", str(STUDY_EPOCHS),
                                    "--compress", STUDY_COMPRESS, "--attention", "--serving"])
        print(f"  the study: {time.perf_counter() - t0:.1f}s")
    study_launches = {**siren_cuda.launches, **siren_train_cuda.launches,
                      "siren_decode_batch (bf16)": siren_cuda.bf16_launches["siren_decode_batch"]}
    # Every bf16 2C launch of the study (the aggregate decode's) went through csrc/siren_decode_bf16.cu.
    assert siren_cuda.wgmma_launches["siren_decode_batch"] == study_launches["siren_decode_batch (bf16)"], (
        siren_cuda.wgmma_launches, study_launches)

    # ---- 5. what the study wrote ----
    with phase("5 study checks"):
        check_study(study_root, stage_seconds, tmp)
        check_pt_checkpoints(study_root / "fits")
        print(f"  the host generator, seconds per cache (S): "
              + ", ".join(f"{sec:.2f} ({seq_len})" for sec, _, _, seq_len in cache_calls)
              + f"; {sum(c[0] for c in cache_calls):.1f}s for {len(cache_calls)} caches")
        print(f"  quantize experiment: {quant_calls[0][0]:.1f}s; QAT at N={N_FITS}: "
              + ", ".join(f"{sec:.2f}s for {a} steps ({1e3 * sec / a:.3f} ms a step)" for sec, a, _, _ in qat_calls)
              + f" (the experiment's, then compress's); compress stage {stage_seconds['compress']:.1f}s")

    with phase("2 build, the rest"):
        built([name for name in builds if name not in STUDY_LIBRARIES])

    # ---- 3. kernels against their plain versions ----
    with phase("3 kernels"):
        started = time.perf_counter()
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
                **tc_bound(2 * macs * SEQ_LEN * n, n * (pbytes + SEQ_LEN * HEAD_DIM * 4)),
            )
            print(f"  {wrapper} N={n}: kernel {report[wrapper]['ms']:.4f} ms, "
                  f"plain {report[wrapper]['plain_ms']:.4f} ms, bound {report[wrapper]['bound_ms']:.5f} ms "
                  f"({report[wrapper]['bound_by']}, TF32 peak; fp32 peak {report[wrapper]['fp32_bound_ms']:.4f} ms)")
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

        def targets_for(n, seq_len, seed, width=HEAD_DIM):
            gen = torch.Generator().manual_seed(seed)
            return normalize_targets(torch.randn(n, seq_len, width, generator=gen).to(dev))[0].contiguous()

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
        train_err = attn_padded_err = 0.0
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
        # Shapes the kernels take only with zero units added: hidden 96 (2A pads to 128), no hidden layer,
        # D=3 and 18 (to 4 and 20 for 2A; the decode stack computes at 8 and 24), 16 layers.
        for hidden, layers, d_out in PADDED_SHAPES:
            config = SIRENConfig(hidden, layers, medium.omega_0, "padded")
            gen = torch.Generator().manual_seed(hidden + layers + d_out)
            nets = [SirenStack.from_params(init_siren(config, d_out, generator=gen, n=NUM_HEADS)) for _ in "kv"]
            k_pad, v_pad = (SirenStack(s.flat.to(dev), s.dims) for s in nets)
            tag = f"H={hidden} L={layers + 2} D={d_out}"
            # FM x64 but at 16 layers, where fp32 rounding carried through 15 sine layers exceeds the
            # tolerance: fm_depth_witness, below, holds the kernels and the plain version to float64 there.
            for sin_impl, fm in (("exact", None), ("fast", FM_MULT if layers < 14 else None)):
                kw = dict(sin_impl=sin_impl, fm_mult=fm)
                got = siren_cuda.siren_decode_batch(k_pad, config.omega_0, 300, **kw)
                want = siren_cuda.siren_decode_plain(k_pad, config.omega_0, 300, **kw)
                torch.cuda.synchronize()
                err = check_close(f"siren_decode_batch N={NUM_HEADS} S=300 {tag} {sin_impl} fm={fm} (padded)",
                                  got, want, **DECODE_TOL)
                report["siren_decode_batch"]["max_abs_err"] = max(report["siren_decode_batch"]["max_abs_err"], err)
                assert torch.equal(got, siren_cuda.siren_decode_batch(k_pad, config.omega_0, 300, **kw))
            train_err = max(train_err, check_train(
                k_pad, targets_for(NUM_HEADS, 300, seed=hidden, width=d_out), f"siren_train_grads {tag} S=300 exact "
                "(padded)", TRAIN_TOL["exact"], omega=config.omega_0, sin_impl="exact"))
            stats = [(torch.rand(NUM_HEADS, 1, d_out, generator=gen) + 0.5).to(dev) for _ in range(4)]
            q = torch.randn(NUM_HEADS, 4, d_out, generator=gen).to(dev)
            got = siren_attention_cuda.siren_attention_decode_fused(k_pad, v_pad, *stats, q, config.omega_0, 300)
            want = siren_attention_cuda.siren_attention_decode_plain(k_pad, v_pad, *stats, q, config.omega_0, 300)
            torch.cuda.synchronize()
            attn_padded_err = max(attn_padded_err, check_close(
                f"siren_attention_decode_fused N={NUM_HEADS} S=300 T=4 {tag} fast causal (padded)", got, want,
                **ATTN_TOL))
            assert torch.equal(got, siren_attention_cuda.siren_attention_decode_fused(
                k_pad, v_pad, *stats, q, config.omega_0, 300))

        # Forward, and the backward's two products per layer: 6 flops per multiply-add, on the tensor cores
        # in TF32 (3xTF32 counted once; the three passes' floor is printed beside it).
        macs, pbytes = siren_macs(layer_dims(medium, HEAD_DIM))
        train_flops = 6 * macs * SEQ_LEN * N_FITS
        report["siren_train_grads"] = dict(
            max_abs_err=train_err, ms=train_ms["medium"][0], plain_ms=train_ms["medium"][1],
            shape=f"medium, N={N_FITS}, S={SEQ_LEN}, D={HEAD_DIM}, fast sine, loss + all grads", library_ms=None,
            **tc_bound(train_flops, N_FITS * (SEQ_LEN * HEAD_DIM * 4 + 2 * pbytes + 4)),
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

        part_s = {"2A-2D at the main shapes": time.perf_counter() - started}

        def part(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            part_s[name] = time.perf_counter() - t0
            return out

        part("fm depth", fm_depth_witness, dev)
        report["siren_decode_batch"]["max_abs_err"] = max(report["siren_decode_batch"]["max_abs_err"],
                                                          part("wide nets", check_wide_nets, dev, median_ms))
        part("tile costs", tile_costs, dev, stack_for)

        report.update(part("attention", check_attention_kernels, dev, median_ms))
        report["siren_attention_decode_fused"]["max_abs_err"] = max(
            report["siren_attention_decode_fused"]["max_abs_err"], attn_padded_err)
        report.update(part("mla", check_mla_kernels, dev, median_ms))
        report["siren_decode_batch_quant"] = part("2E", check_decode_quant_kernel, dev, median_ms, stack_for)
        bf16_report, bf16_launches = part("bf16 modes", check_bf16_kernels, dev, median_ms, stack_for)
        report.update(bf16_report)
        report["siren_decode_batch (bf16)"] = part("study shapes", check_study_shapes, dev, median_ms, stack_for,
                                                   targets_for, check_train)
        total_len_errs = part("total_len", check_total_len, stack_for, targets_for, check_train)
        print("  seconds of the phase's parts: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
        report["siren_train_grads"]["max_abs_err"] = max(report["siren_train_grads"]["max_abs_err"], total_len_errs[0])
        report["siren_decode_batch"]["max_abs_err"] = max(report["siren_decode_batch"]["max_abs_err"],
                                                          total_len_errs[1])
        check_compressed_payloads(stack_for)

    with workdir:
        # ---- 6. launches on the study path ----
        with phase("6 launches"):
            print(f"  {study_launches}")
            for name, count in study_launches.items():
                assert count > 0, f"{name} was not launched on the study path"
            qat_2a = [a for _, a, _, _ in qat_calls]
            recon_2c = [c for _, _, c, _ in recon_calls]
            print(f"  of them QAT's 2A launches {qat_2a} (the quantize experiment's, then compress's), and the "
                  f"reconstructions' 2C launches {sum(recon_2c)} ({len(recon_2c)} reconstructions: "
                  f"{N_FITS} x {len(QUANT_SCHEMES)} schemes, then compress's {N_FITS} verifications)")
            assert qat_2a == [QAT_EPOCHS, QAT_EPOCHS], qat_2a
            assert recon_2c == [1] * N_FITS * (len(QUANT_SCHEMES) + 1), recon_2c
            # The attention stage: one fit of 2 x heads nets per probed layer (STUDY_EPOCHS steps of 2A, one 2C
            # for its final evaluation), then K-hat and V-hat (one 2C each). The serving stage: one fit of the
            # 64 unit slices, then one reconstruction per payload.
            stages = {"attention": (attn_calls, attn_recon, len(ATTN_LAYERS), 2),
                      "serving": (hp_calls, hp_recon, 1, len(HP_PAYLOADS))}
            for stage, (calls, recons, fits, per_fit) in stages.items():
                (_, a, c, _), = calls
                want = (fits * STUDY_EPOCHS, fits + fits * per_fit, [1] * fits * per_fit)
                got = (a, c, [c for _, _, c, _ in recons])
                print(f"  the {stage} stage: 2A {a}, 2C {c} ({len(recons)} reconstructions, one 2C each); "
                      f"expected {want[:2]}")
                assert got == want, (stage, got, want)
        launches = {**study_launches, **bf16_launches}

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
            layers = [kvstore.load_layer(study_root / "kv_cache", layer) for layer in SWEEP_LAYERS]
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

            medium_nets = stack_for(medium, N_FITS, seed=16)
            one_net = stack_for(medium, 1, seed=18)
            twice = {
                "2A": train_large,
                "2C": lambda: siren_cuda.siren_decode_batch(medium_nets, medium.omega_0, SEQ_LEN, sin_impl="fast"),
                "2C bf16": lambda: siren_cuda.siren_decode_batch(medium_nets, medium.omega_0, SEQ_LEN,
                                                                 compute_dtype=torch.bfloat16),
                "2B bf16": lambda: siren_cuda.siren_decode(one_net, medium.omega_0, SEQ_LEN, compute_dtype=torch.bfloat16),
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
            t0 = time.perf_counter()
            hybrid = hybrid_model(dev)  # phase 15's too
            config, params, (k_nets, v_nets, hstats), served = hybrid
            print(f"  the hybrid engine's model: {config.num_hidden_layers} layers at Llama-3.1-8B widths, fp32 "
                  f"weights drawn on the card from seed 0, {2 * served.size} `small` K and V nets from seed 1: "
                  f"{time.perf_counter() - t0:.1f}s")
            hk, hv = random_kv(config, SEQ_LEN, dev, seed=17)
            hck, hcv = (unserved_rows(c, served, SEQ_LEN) for c in (hk, hv))
            hybrid_step, _ = llama_hybrid.make_hybrid_decode_step(config, params, served, k_nets.params(),
                                                                  v_nets.params(), *hstats, 30.0, scheme="int4_g128",
                                                                  device=dev)
            twice["hybrid step"] = lambda: hybrid_step(7, hck, hcv)
            for name, run in twice.items():
                a, b = run(), run()
                same = all(torch.equal(x, y) for x, y in zip(a if isinstance(a, tuple) else (a,),
                                                             b if isinstance(b, tuple) else (b,)))
                what = {"2A": f"large, N={N_FITS}, S={SEQ_LEN}, the sweep's targets, loss and grads",
                        "2C": f"medium, N={N_FITS}, S={SEQ_LEN}, fast sine",
                        "2C bf16": f"medium, N={N_FITS}, S={SEQ_LEN}, exact sine, bf16 mode",
                        "2B bf16": f"medium, S={SEQ_LEN}, exact sine, bf16 mode",
                        "2G": "H=16, S_buf=32768", "2H": "H=16, S_buf=32768",
                        "2E": f"{PLAN_NETS} small nets, S={PLAN_SEQ_LEN}, int4_g128",
                        "hybrid step": f"Llama-3.1-8B widths, {LLAMA_31_8B['num_hidden_layers']} layers, "
                                       f"S={SEQ_LEN}, int4_g128 payloads"}.get(name, "T=16")
                print(f"  {name} twice on the same inputs ({what}): bit-identical = {same}")
                assert same
            del config, params, k_nets, v_nets, hstats, hk, hv, hck, hcv, hybrid_step, twice

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
        siren_quant_cuda.launches["siren_attention_decode_quant"] = 0  # 2F: the hybrid legs
        with phase("13 plan"):
            print(f"  Llama-3.1-8B widths: hidden 4096, 32 query / 8 KV heads, head_dim 128, SiLU FFN 14336, "
                  "rope_theta 500000 with llama3 scaling (factor 8, low 1, high 4, original 8192), rms eps 1e-5; "
                  "fp32, TF32 off; phase 9's weights (drawn on the card from seed 0) with the tool's head gains "
                  "(1-64)")
            print(f"  cuts: {'; '.join(PLAN_CUTS)}")
            print("  the tool's defaults otherwise: S=512, 64 rollout tokens, budgets 0.003/0.01/0.03, schemes "
                  f"master/int8_g32/int4_g128, `small` nets, 2000 epochs, 8 queries; one timing sample = {PLAN_REPS} "
                  "back-to-back rollouts (or reconstructions) between CUDA events, median of 3 samples; --hybrid: "
                  "the top budget's served set as a hybrid rollout per scheme, 3 samples of 2 rollouts")
            # The tool draws init_random_llama(LLAMA_31_8B, seed 0) on the host (~1 min of numpy): it is handed
            # phase 9's weights instead, drawn on the card with the same shapes and scales (apply_head_gains scales
            # copies, not them).
            draw = plan_rollout_study.init_random_llama
            plan_rollout_study.init_random_llama = lambda cfg, seed=0, dtype=torch.float32, device=None: (
                hybrid[1] if (cfg, seed, dtype) == (hybrid[0], 0, torch.float32) else draw(cfg, seed, dtype, device))
            try:
                plan_payload = plan_rollout_study.main([
                    "--out", str(tmp / "plan_rollout.json"), "--seeds", "0", "--llama_config",
                    json.dumps(LLAMA_31_8B), "--timing_reps", str(PLAN_REPS), "--reduced", *PLAN_CUTS, "--hybrid"])
            finally:
                plan_rollout_study.init_random_llama = draw
        plan_launches = {key: counts[key] for counts, key in plan_kernels}
        hybrid_launches = {"siren_attention_decode_quant (phase 13)": siren_quant_cuda.launches[
            "siren_attention_decode_quant"]}

        # ---- 14. launches on the plan path, and its JSON ----
        with phase("14 launches"):
            print(f"  {plan_launches}")
            for name, count in plan_launches.items():
                assert count > 0, f"{name} was not launched on the plan path"
            check_plan(plan_payload)
        for name, count in plan_launches.items():  # the kernels line counts every path's launches
            launches[name] = launches.get(name, 0) + count

        # ---- 15. the hybrid engine at Llama-3.1-8B's widths ----
        siren_quant_cuda.launches["siren_attention_decode_quant"] = 0
        kv_quant_cuda.launches["kv_cache_attention_quant"] = 0
        with phase("15 hybrid"):
            check_hybrid(dev, median_ms, hybrid)
            del hybrid
        hybrid_launches["siren_attention_decode_quant (phase 15)"] = siren_quant_cuda.launches[
            "siren_attention_decode_quant"]
        hybrid_launches["kv_cache_attention_quant (phase 15)"] = kv_quant_cuda.launches["kv_cache_attention_quant"]

        # ---- 16. launches on the hybrid paths ----
        with phase("16 launches"):
            print(f"  {hybrid_launches}")
            for name, count in hybrid_launches.items():
                assert count > 0, f"{name} was not launched on the hybrid path"
        for name, count in hybrid_launches.items():
            launches[name.split(" ")[0]] += count

        # ---- 17. the incremental experiment, both coordinate conventions ----
        incr_kernels = ((siren_train_cuda.launches, "siren_train_grads"), (siren_cuda.launches, "siren_decode_batch"))
        with phase("17 incremental"):
            print(f"  python -m nerf_attention_tpu_torch.experiments incremental: the study's cache geometry "
                  f"({NUM_LAYERS} layers, {NUM_HEADS} heads, D={HEAD_DIM}) grown {SEQ_LEN} -> {INCR_FINAL} by "
                  f"{INCR_CHUNK}, layer 8, 2 heads' K and V (N=4), medium nets, relative then absolute coordinates")
            print(f"  cuts: {'; '.join(INCR_CUTS)}")
            for coords in ("relative", "absolute"):
                for counts, key in incr_kernels:
                    counts[key] = 0
                warm, stale, cache = [], [], []
                fit, evaluate = incremental._fit_with_trajectory, incremental._eval_batch

                def fit_recording(targets, init_params, **kw):
                    params, traj = fit(targets, init_params, **kw)
                    if isinstance(init_params, SirenStack):  # a warm start: the previous snapshot's nets
                        warm.append(traj[:, 0].cpu().numpy())
                    return params, traj

                def eval_recording(*args, **kw):
                    stale.append(evaluate(*args, **kw))
                    return stale[-1]

                incremental._fit_with_trajectory, incremental._eval_batch = fit_recording, eval_recording
                t0 = time.perf_counter()
                try:
                    with counted(synthetic, "generate_synthetic_kv", cache):
                        experiments_cli.main([
                            "incremental", "--results_root", str(tmp / "incremental"), "--kv_dir",
                            str(study_root / "kv_cache"), "--siren_dir", str(study_root / "fits"),
                            "--seq_len", str(SEQ_LEN), "--incr_final_len", str(INCR_FINAL), "--incr_chunk",
                            str(INCR_CHUNK), "--epochs", str(INCR_EPOCHS), "--incr_warm_epochs", str(INCR_WARM),
                            "--incr_coords", coords])
                finally:
                    incremental._fit_with_trajectory, incremental._eval_batch = fit, evaluate
                took = time.perf_counter() - t0
                incr_launches = {key: counts[key] for counts, key in incr_kernels}
                sub = "incremental" if coords == "relative" else f"incremental_{coords}"
                check_incremental(tmp / "incremental" / sub, coords, warm, stale)
                want = {"siren_train_grads": INCR_SNAPSHOTS * INCR_EPOCHS + 8 * INCR_WARM,
                        "siren_decode_batch": INCR_SNAPSHOTS * INCR_EPOCHS + 8 * INCR_WARM + 8}
                print(f"  {coords}: {took:.1f}s, of it the {NUM_LAYERS}-layer S={INCR_FINAL} cache "
                      f"{cache[0][0]:.2f}s (the host generator); launches {incr_launches} (expected {want})")
                assert incr_launches == want, incr_launches
                for name, count in incr_launches.items():
                    launches[name] += count

        # ---- 18. the attention end-metric of stored payloads, QAT included ----
        for counts, key in incr_kernels:
            counts[key] = 0
        with phase("18 stored"):
            qat_calls = []
            print(f"  python -m nerf_attention_tpu_torch.experiments attention_error --schemes "
                  f"{','.join(ATTN_STORED_SCHEMES)} --epochs {STUDY_EPOCHS} --qat_epochs {QAT_EPOCHS} on phase 4's "
                  "cache")
            t0 = time.perf_counter()
            with counted(attention_error, "qat_finetune_batch", qat_calls):
                experiments_cli.main([
                    "attention_error", "--results_root", str(tmp / "stored"), "--kv_dir", str(study_root / "kv_cache"),
                    "--siren_dir", str(study_root / "fits"), "--epochs", str(STUDY_EPOCHS), "--qat_epochs",
                    str(QAT_EPOCHS), "--schemes", ",".join(ATTN_STORED_SCHEMES)])
            stored = json.loads((tmp / "stored" / "attention_error" / "attention_error_results.json").read_text())
            check_attention_error(stored, ATTN_STORED_SCHEMES)
            stored_launches = {key: counts[key] for counts, key in incr_kernels}
            n_qat = sum(s.endswith("_qat") for s in ATTN_STORED_SCHEMES)
            fits = len(ATTN_LAYERS)
            want = {"siren_train_grads": fits * (STUDY_EPOCHS + n_qat * QAT_EPOCHS),
                    "siren_decode_batch": fits * (1 + 2 * (1 + len(ATTN_STORED_SCHEMES)))}
            qat_seconds = ", ".join(f"{sec:.2f}s" for sec, *_ in qat_calls)
            print(f"  {time.perf_counter() - t0:.1f}s; QAT {len(qat_calls)} runs of "
                  f"{[a for _, a, _, _ in qat_calls]} 2A launches ({qat_seconds}); launches {stored_launches} "
                  f"(expected {want})")
            assert stored_launches == want, stored_launches
            assert [a for _, a, _, _ in qat_calls] == [QAT_EPOCHS] * fits * n_qat
        for name, count in stored_launches.items():
            launches[name] += count

        # ---- 19. the card against the CPU ----
        with phase("19 card vs cpu"):
            card_against_cpu(study_root / "kv_cache", tmp)

        # ---- 20. serving at Llama-3.1-8B's attention widths ----
        for counts, key in incr_kernels:
            counts[key] = 0
        with phase("20 serving 8B"):
            serving_at_8b_widths(study_root / "kv_cache", tmp)
            # One fit of the 2 x 4 x 8 unit slices, its final evaluation, one reconstruction per payload.
            serving_launches = {key: counts[key] for counts, key in incr_kernels}
            want = {"siren_train_grads": STUDY_EPOCHS, "siren_decode_batch": 1 + len(HP_PAYLOADS)}
            print(f"  launches {serving_launches} (expected {want})")
            assert serving_launches == want, serving_launches
        for name, count in serving_launches.items():
            launches[name] += count

        # ---- 21. the Llama families and the HF loaders at GPT-OSS-20B's widths ----
        with phase("21 families"):
            family_launches, family_err = families_at_gpt_oss_width(dev, tmp, experiments_cli, median_ms, check_train)
            for name, e in family_err.items():
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
            want = {"siren_train_grads": STUDY_EPOCHS * (1 + len(HP_AXES)),
                    "siren_decode_batch": 2 + len(HP_AXES) * (1 + len(HP_PAYLOADS)), "mla_absorbed_attention": 2}
            print(f"  launches {family_launches} (expected {want})")
            assert family_launches == want, family_launches
        for name, count in family_launches.items():
            launches[name] += count

        # ---- 22. the text-in path at Llama-3.1-8B's widths ----
        with phase("22 text"):
            text_launches, text_err = text_path_at_8b_width(dev, tmp, experiments_cli, check_train)
            for name, e in text_err.items():
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
            print(f"  launches {text_launches}; largest errors against the plain versions {text_err}")
            assert all(text_launches.values()), text_launches
        for name, count in text_launches.items():
            launches[name] += count

        # ---- 23. the shared-basis and MLA latent studies, fit --profile_dir ----
        with phase("23 studies"):
            studies_launches, studies_err = studies_on_the_card(dev, tmp, study_root / "kv_cache", check_train)
            for name, e in studies_err.items():
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
            print(f"  launches {studies_launches}; largest errors against the plain versions {studies_err}")
        for name, count in studies_launches.items():
            launches[name] += count

        # ---- 24. the ported root tools ----
        with phase("24 tools"):
            tools_launches, tools_err, tool_seconds = root_tools_on_the_card(dev, tmp, check_train,
                                                                             tmp / "plan_rollout.json")
            for name, e in tools_err.items():
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
            print(f"  launches {tools_launches}; largest errors against the plain versions {tools_err}")
            print("  seconds per tool: " + ", ".join(f"{k} {v:.1f}" for k, v in tool_seconds.items()))
        for name, count in tools_launches.items():
            launches[name] += count

        # ---- 25. the multi-device paths over a fit mesh ----
        with phase("25 mesh"):
            mesh_launches = mesh_on_the_card(dev, tmp, study_root / "kv_cache")
            print(f"  sharded launches over every rank of every world: {mesh_launches}")
        for name, count in mesh_launches.items():
            launches[name] = launches.get(name, 0) + count

    sources = {
        "siren_train_grads": ("nerf_attention_tpu_torch/csrc/siren_train.cu",
                              "nerf_attention_tpu/ops/siren_train_pallas.py:252"),
        "siren_decode": ("nerf_attention_tpu_torch/csrc/siren_decode.cu",
                         "nerf_attention_tpu/ops/siren_pallas.py:120"),
        "siren_decode_batch": ("nerf_attention_tpu_torch/csrc/siren_decode.cu",
                               "nerf_attention_tpu/ops/siren_pallas.py:279"),
        "siren_decode_batch (bf16)": ("nerf_attention_tpu_torch/csrc/siren_decode_bf16.cu",
                                      "nerf_attention_tpu/ops/siren_pallas.py:279"),
        "siren_attention_decode_fused": ("nerf_attention_tpu_torch/csrc/siren_attention.cuh",
                                         "nerf_attention_tpu/ops/siren_attention_pallas.py:151"),
        "siren_attention_decode_quant": ("nerf_attention_tpu_torch/csrc/siren_attention.cuh",
                                         "nerf_attention_tpu/ops/siren_quant_pallas.py:512"),
        "kv_cache_attention_quant": ("nerf_attention_tpu_torch/csrc/kv_quant_attention.cu",
                                     "nerf_attention_tpu/ops/kv_quant_pallas.py:172"),
        "mla_absorbed_attention": ("nerf_attention_tpu_torch/csrc/mla_absorbed_attention.cu",
                                   "nerf_attention_tpu/ops/mla_absorbed_pallas.py:138"),
        "mla_absorbed_attention_quant": ("nerf_attention_tpu_torch/csrc/mla_absorbed_attention.cu",
                                         "nerf_attention_tpu/ops/mla_quant_pallas.py:249"),
        "siren_decode_batch_quant": ("nerf_attention_tpu_torch/csrc/siren_decode.cu",
                                     "nerf_attention_tpu/ops/siren_quant_pallas.py:285"),
        "siren_attention_decode_fused (bf16)": ("nerf_attention_tpu_torch/csrc/siren_attention_wgmma.cu",
                                                "nerf_attention_tpu/ops/siren_attention_pallas.py:151"),
        "siren_attention_decode_quant (bf16)": ("nerf_attention_tpu_torch/csrc/siren_attention_wgmma.cu",
                                                "nerf_attention_tpu/ops/siren_quant_pallas.py:512"),
        "siren_decode_batch_quant (bf16)": ("nerf_attention_tpu_torch/csrc/siren_decode_act16.cu",
                                            "nerf_attention_tpu/ops/siren_quant_pallas.py:285"),
    }
    keys = ("max_abs_err", "ms", "device_ms", "cold_device_ms", "plain_ms", "fp32_ms", "stack_ms", "bound_ms",
            "bound_by", "epilogue_floor_ms", "epilogue_floor_fast_ms",
            "library_ms", "shape", "fp32_bound_ms", "device_shape", "device_bound_ms", "device_library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         **{k: report[name][k] for k in keys if k in report[name]}}
        for name, (src, rep) in sources.items()
    ]
    print(f"phases: {sum(PHASE_SECONDS.values()):.2f}s in all")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
