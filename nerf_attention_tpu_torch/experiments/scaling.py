"""Experiment 1: sequence-length scaling, and the all-layer profile.

``nerf_attention_tpu/experiments/scaling.py`` on torch. Per length of the
ladder: a synthetic cache, the structure analysis, 6 medium fits (layers {0,
L/2, L-1}, head 0, K and V) trained as one batch (kernel 2A), their
checkpoints, the decode time of up to 4 of them (kernel 2B) and a measured
read of one slice; then the power-law crossover of decode against read
(``crossover_data.json``, written whether or not the figure is drawn). The
layer profile fits a medium SIREN to head 0's K and V of every layer, as one
batch. The caches come from the synthetic generator, or from a checkpoint
directory through the ``hf`` or ``jax`` backend (``extract.py``; the model
loads once for the whole ladder, each length extracted from the joined prompt
corpus and kept on disk for a later run); the layer profile regenerates its
cache only for the synthetic backend, a real model's cache it reads as it is.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from nerf_attention_tpu_torch import figdata
from nerf_attention_tpu_torch.analyze import analyze_kv_cache
from nerf_attention_tpu_torch.evaluate import HBM_BW
from nerf_attention_tpu_torch.fit import _batch_to_fit_result, result_to_record
from nerf_attention_tpu_torch.io import checkpoint, kvstore
from nerf_attention_tpu_torch.parallel.mesh import barrier, mesh_device
from nerf_attention_tpu_torch.parallel.sweep import fit_batch
from nerf_attention_tpu_torch.synthetic import ensure_synthetic_cache
from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME, KVMetadata
from nerf_attention_tpu_torch.utils.device import resolve_device
from nerf_attention_tpu_torch.utils.plotting import pyplot
from nerf_attention_tpu_torch.utils.timing import measured_hbm_read_ms, time_siren_forward_ms

MEDIUM = CONFIGS_BY_NAME["medium"]


def _extract_all_seq_lengths(
    model_name: str,
    seq_lengths: list[int],
    base_dir: Path,
    backend: str = "synthetic",
    synth_layers: int = 32,
    synth_heads: int = 8,
    synth_dim: int = 128,
    values_mode: str = "reference",
    verbose: bool = True,
    device: torch.device | str | None = None,
) -> dict[int, KVMetadata]:
    """A cache for every length under ``base_dir/seq_<S>/kv_cache``, the model loaded at most once.

    The synthetic backend follows the reuse policy of ``ensure_synthetic_cache``;
    a real model's cache already on disk is reused, and an out-of-memory error
    ends the ladder at that length (both as the JAX function does).
    """
    from nerf_attention_tpu_torch.experiments.prompts import get_prompts
    from nerf_attention_tpu_torch.extract import extract_kv_cache_jax, extract_with_hf

    metadata_map: dict[int, KVMetadata] = {}
    hf_state: dict = {}  # hf backend: the model loaded lazily, once
    jax_state: dict = {}  # jax backend: checkpoint and tokenizer loaded once
    for seq_len in seq_lengths:
        kv_dir = base_dir / f"seq_{seq_len}" / "kv_cache"
        if backend != "synthetic" and (kv_dir / "metadata.json").exists():
            if verbose:
                print(f"\n  seq_len={seq_len}: already extracted, skipping")
            metadata_map[seq_len] = kvstore.load_metadata(kv_dir)
            continue
        if verbose:
            print(f"\n  Extracting seq_len={seq_len}...")
        try:
            if backend == "synthetic":
                metadata_map[seq_len] = ensure_synthetic_cache(
                    kv_dir, values_mode=values_mode, seq_len=seq_len, num_layers=synth_layers,
                    num_kv_heads=synth_heads, head_dim=synth_dim, verbose=verbose,
                )
            elif backend == "hf":
                text = "\n\n".join(get_prompts().values()) * 3
                metadata_map[seq_len] = extract_with_hf(model_name, text, seq_len, kv_dir, state=hf_state,
                                                        device=device)
            elif backend == "jax":
                text = "\n\n".join(get_prompts().values()) * 3
                metadata_map[seq_len] = extract_kv_cache_jax(model_name, seq_len, kv_dir, text=text, state=jax_state,
                                                             device=device)
            else:
                raise ValueError(f"unknown backend {backend!r}")
        except (RuntimeError, ValueError, MemoryError) as e:
            if "out of memory" in str(e).lower() or "resource exhausted" in str(e).lower():
                print(f"    OOM at seq_len={seq_len}, stopping extraction")
                break
            raise
    return metadata_map


def run_scaling_experiment(
    model_name: str,
    seq_lengths: list[int],
    base_dir: Path,
    epochs: int = 2000,
    backend: str = "synthetic",
    synth_layers: int = 32,
    values_mode: str = "reference",
    fm_mult: float | None = None,
    verbose: bool = True,
    device: torch.device | str | None = None,
) -> dict[int, dict]:
    """Cache, analysis and 6 medium fits at each sequence length, with their latency record.

    ``fm_mult`` runs the ladder on FM-SIRENs (per-unit first-layer frequencies).
    """
    base_dir = Path(base_dir)
    device = resolve_device(device)
    base_dir.mkdir(parents=True, exist_ok=True)
    scaling_results: dict[int, dict] = {}
    metadata_map = _extract_all_seq_lengths(
        model_name, seq_lengths, base_dir, backend, synth_layers=synth_layers, values_mode=values_mode,
        verbose=verbose, device=device,
    )

    for seq_len in seq_lengths:
        if seq_len not in metadata_map:
            continue
        if verbose:
            print(f"\n{'=' * 60}")
            print(f"SCALING: analyze + fit seq_len = {seq_len}")
            print(f"{'=' * 60}")
        metadata = metadata_map[seq_len]
        seq_dir = base_dir / f"seq_{seq_len}"
        kv_dir = seq_dir / "kv_cache"
        fits_dir = seq_dir / "fits"
        fits_dir.mkdir(parents=True, exist_ok=True)

        analysis = analyze_kv_cache(kv_dir, seq_dir / "analysis", verbose=verbose, device=device)

        layers_to_fit = sorted({0, metadata.num_layers // 2, metadata.num_layers - 1})
        grid: list[tuple[int, str]] = []
        tensors: list[np.ndarray] = []
        for layer_idx in layers_to_fit:
            if not kvstore.has_layer(kv_dir, layer_idx):
                if verbose:
                    print(f"  Skipping layer {layer_idx} (not found)")
                continue
            keys, values = kvstore.load_layer(kv_dir, layer_idx)
            for kv_type, tensor in (("key", keys[0]), ("value", values[0])):
                grid.append((layer_idx, kv_type))
                tensors.append(np.asarray(tensor, dtype=np.float32))
        if not tensors:
            raise FileNotFoundError(f"no sampled layer files under {kv_dir} (layers {layers_to_fit})")

        batch = fit_batch(np.stack(tensors), MEDIUM, epochs=epochs, fm_mult=fm_mult, device=device)
        fit_results = []
        for i, (layer_idx, kv_type) in enumerate(grid):
            result = _batch_to_fit_result(batch, i, MEDIUM, metadata.seq_len, metadata.head_dim)
            name = f"L{layer_idx}_H0_{kv_type}_medium"
            fit_results.append({
                "name": name,
                "kv_type": kv_type,
                "layer": layer_idx,
                "final_cosine_mean": result.final_cosine_mean,
                "compression_ratio": result.compression_ratio,
            })
            checkpoint.save_siren_checkpoint(
                fits_dir / f"{name}_model.npz", result.params, MEDIUM, metadata.head_dim, result.target_mean,
                result.target_std, result_to_record(name, layer_idx, 0, kv_type, result), fm_mult=fm_mult,
            )
            if verbose:
                print(f"  {name}: CosSim={result.final_cosine_mean:.4f}, Compress={result.compression_ratio:.1f}x")

        siren_time_ms = _profile_siren_latency(fits_dir, metadata.seq_len, device=device)
        hbm_measured_ms = measured_hbm_read_ms(metadata.seq_len, metadata.head_dim, device=device)
        raw_bytes = metadata.seq_len * metadata.head_dim * 2  # an fp16 KV cache
        key_r = [r for r in fit_results if r["kv_type"] == "key"]
        val_r = [r for r in fit_results if r["kv_type"] == "value"]
        scaling_results[seq_len] = {
            "seq_len": metadata.seq_len,
            "head_dim": metadata.head_dim,
            "actual_tokens": metadata.actual_tokens,
            "autocorr_keys": analysis.avg_autocorr_keys,
            "autocorr_values": analysis.avg_autocorr_values,
            "spectral_keys": analysis.avg_spectral_keys,
            "spectral_values": analysis.avg_spectral_values,
            "avg_cossim_keys": float(np.mean([r["final_cosine_mean"] for r in key_r])) if key_r else 0.0,
            "avg_cossim_values": float(np.mean([r["final_cosine_mean"] for r in val_r])) if val_r else 0.0,
            "avg_compression": float(np.mean([r["compression_ratio"] for r in fit_results])),
            "siren_time_ms": siren_time_ms,
            "hbm_measured_ms": hbm_measured_ms,
            "hbm_4060_ms": raw_bytes / HBM_BW["rtx4060"] * 1000,
            "hbm_h100_ms": raw_bytes / HBM_BW["h100"] * 1000,
            "hbm_v5e_ms": raw_bytes / HBM_BW["tpu_v5e"] * 1000,
            "num_experiments": len(fit_results),
            "fm_mult": fm_mult,
        }
        if verbose:
            sr = scaling_results[seq_len]
            print(f"\n  seq_len={metadata.seq_len}: keys={sr['avg_cossim_keys']:.4f}, "
                  f"values={sr['avg_cossim_values']:.4f}")
            print(f"  SIREN={siren_time_ms:.3f}ms, HBM(measured)={hbm_measured_ms:.4f}ms, "
                  f"HBM(4060)={sr['hbm_4060_ms']:.4f}ms, HBM(H100)={sr['hbm_h100_ms']:.5f}ms")

    with open(base_dir / "scaling_results.json", "w") as f:
        json.dump({str(k): v for k, v in scaling_results.items()}, f, indent=2)
    return scaling_results


def _profile_siren_latency(fits_dir: Path, seq_len: int, max_models: int = 4,
                           device: torch.device | str | None = None) -> float:
    """Mean decode time (kernel 2B on a GPU) of up to ``max_models`` saved checkpoints (ms)."""
    model_files = checkpoint.checkpoint_glob(Path(fits_dir))
    if not model_files:
        return 0.0
    times = []
    for mf in model_files[:max_models]:
        ckpt = checkpoint.load_siren_checkpoint(mf)
        times.append(time_siren_forward_ms(ckpt["params"], ckpt["config"].omega_0, seq_len,
                                           fm_mult=ckpt.get("fm_mult"), device=device))
    return float(np.mean(times)) if times else 0.0


def _by_actual_length(scaling_results: dict[int, dict]) -> list[dict]:
    """The records by their ACTUAL length, ascending (an extraction may
    truncate, so two requested lengths can yield one; the first counts)."""
    by_actual: dict[int, dict] = {}
    for r in scaling_results.values():
        by_actual.setdefault(r["seq_len"], r)
    return sorted(by_actual.values(), key=lambda r: r["seq_len"])


def crossover_data(scaling_results: dict[int, dict], head_dim: int | None = None) -> dict | None:
    """The power-law fit of decode time against length and its crossovers with
    each linear read (n^a 10^b = n c), or None with fewer than two lengths."""
    entries = _by_actual_length(scaling_results)
    if len(entries) < 2:
        return None
    if head_dim is None:
        head_dim = entries[0].get("head_dim", 128)
    seq_lens = [r["seq_len"] for r in entries]
    siren_us = [r["siren_time_ms"] * 1000 for r in entries]
    hbm_4060_us = [r["hbm_4060_ms"] * 1000 for r in entries]
    hbm_v5e_us = [r["hbm_v5e_ms"] * 1000 for r in entries]
    hbm_meas_us = [r.get("hbm_measured_ms", 0.0) * 1000 for r in entries]
    a, b = np.polyfit(np.log10(seq_lens), np.log10(siren_us), 1)
    per_token_us = {name: head_dim * 2 / bw * 1e6 for name, bw in HBM_BW.items()}
    crossovers = {
        name: (c / 10**b) ** (1 / (a - 1)) if a != 1 else None for name, c in per_token_us.items()
    }
    ratios = [s / h for s, h in zip(siren_us, hbm_4060_us)]
    ratios_v5e = [s / h for s, h in zip(siren_us, hbm_v5e_us)]
    ratios_meas = [s / h for s, h in zip(siren_us, hbm_meas_us) if h > 0]
    return {
        "siren_fit_log_slope": float(a),
        "siren_fit_log_intercept": float(b),
        "siren_scaling": f"time_us ~ n^{a:.3f}",
        "hbm_scaling": "time_us ~ n^1.0 (linear)",
        "latency_ratio_range": [float(min(ratios)), float(max(ratios))],
        "latency_ratio_range_v5e": [float(min(ratios_v5e)), float(max(ratios_v5e))],
        "latency_ratio_range_measured": [float(min(ratios_meas)), float(max(ratios_meas))] if ratios_meas else None,
        "crossover_4060_tokens": crossovers["rtx4060"],
        "crossover_h100_tokens": crossovers["h100"],
        "crossover_v5e_tokens": crossovers["tpu_v5e"],
        "note": "Crossover at billions of tokens — effectively never at practical lengths",
    }


def plot_scaling_crossover(scaling_results: dict[int, dict], output_dir: Path, head_dim: int | None = None) -> None:
    """``crossover_data.json``, then the log-log extrapolation figure where matplotlib imports."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    entries = _by_actual_length(scaling_results)
    data = crossover_data(scaling_results, head_dim)
    if data is None:
        print(f"  Skipping crossover plot: need >=2 sequence lengths, got {len(entries)}")
        return
    with open(output_dir / "crossover_data.json", "w") as f:
        json.dump(data, f, indent=2)
    ratios = data["latency_ratio_range"]
    seq_lens = [r["seq_len"] for r in entries]
    print(f"  SIREN/HBM(4060) ratio: {ratios[0]:.1f}x - {ratios[1]:.1f}x across {seq_lens[0]}-{seq_lens[-1]} tokens")
    print(f"  SIREN fit: time_us ~ n^{data['siren_fit_log_slope']:.3f}")
    for name, key in (("rtx4060", "crossover_4060_tokens"), ("h100", "crossover_h100_tokens"),
                      ("tpu_v5e", "crossover_v5e_tokens")):
        if data[key]:
            print(f"  Analytical crossover ({name}): ~{data[key]:.3g} tokens")

    plt = pyplot("scaling_crossover.png")
    if plt is None:
        return
    if head_dim is None:
        head_dim = entries[0].get("head_dim", 128)
    a, b = data["siren_fit_log_slope"], data["siren_fit_log_intercept"]
    siren_us = [r["siren_time_ms"] * 1000 for r in entries]
    hbm_meas_us = [r.get("hbm_measured_ms", 0.0) * 1000 for r in entries]
    per_token_us = {name: head_dim * 2 / bw * 1e6 for name, bw in HBM_BW.items()}
    max_extrap = max(seq_lens[-1] * 100, 500_000)
    extrap_x = np.logspace(np.log10(min(seq_lens)), np.log10(max_extrap), 300)
    extrap_siren = 10 ** np.polyval([a, b], np.log10(extrap_x))

    fig, ax = plt.subplots(figsize=(10, 7))
    ax.scatter(seq_lens, siren_us, c="#3498db", s=100, zorder=5, label="SIREN (measured wall-clock)")
    if any(h > 0 for h in hbm_meas_us):
        ax.scatter(seq_lens, hbm_meas_us, c="#9b59b6", s=100, zorder=5, marker="*", label="HBM read (measured)")
    for field, color, marker, label in (("hbm_4060_ms", "#e74c3c", "s", "HBM RTX 4060 (theoretical)"),
                                        ("hbm_h100_ms", "#2ecc71", "^", "HBM H100 (theoretical)"),
                                        ("hbm_v5e_ms", "#f39c12", "v", "HBM TPU v5e (theoretical)")):
        ax.scatter(seq_lens, [r[field] * 1000 for r in entries], c=color, s=100, zorder=5, marker=marker,
                   label=label)
    ax.plot(extrap_x, extrap_siren, color="#3498db", linestyle="--", alpha=0.5, linewidth=2)
    for color, name in (("#e74c3c", "rtx4060"), ("#2ecc71", "h100"), ("#f39c12", "tpu_v5e")):
        ax.plot(extrap_x, extrap_x * per_token_us[name], color=color, linestyle="--", alpha=0.5, linewidth=2)
    ax.annotate(
        f"SIREN {ratios[0]:.0f}-{ratios[1]:.0f}x slower\nthan HBM at all lengths",
        xy=(seq_lens[-1], siren_us[-1]), fontsize=9, xytext=(seq_lens[-1] * 5, siren_us[-1] * 0.5),
        arrowprops=dict(arrowstyle="->", color="#3498db", alpha=0.7), color="#3498db",
    )
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set(xlabel="Sequence Length (tokens)", ylabel="Time (microseconds)",
           title=f"SIREN Is {ratios[0]:.0f}-{ratios[1]:.0f}x Slower Than HBM Reads at All Practical Lengths")
    ax.legend(fontsize=9, loc="upper left")
    ax.grid(True, alpha=0.3, which="both")
    plt.tight_layout()
    plt.savefig(output_dir / "scaling_crossover.png", dpi=150, bbox_inches="tight")
    plt.close()
    print(f"  Saved: {output_dir}/scaling_crossover.png")


# The three panels of the scaling-quality figure, as data.
_SCALING_PANEL_SPECS = (
    {
        "series": (("avg_cossim_keys", "bo-", "Keys"), ("avg_cossim_values", "rs-", "Values")),
        "ylabel": "Avg Cosine Similarity",
        "title": "Reconstruction Quality vs Seq Length",
        "guides": ((0.95, "green"),),
    },
    {
        "series": (("avg_compression", "go-", None),),
        "ylabel": "Compression Ratio (x)",
        "title": "Compression Ratio vs Seq Length",
        "guides": (),
    },
    {
        "series": (("autocorr_keys", "bo-", "Keys"), ("autocorr_values", "rs-", "Values")),
        "ylabel": "Lag-1 Autocorrelation",
        "title": "Structure Metrics vs Seq Length",
        "guides": (),
    },
)


def plot_scaling_quality(scaling_results: dict[int, dict], output_dir: Path) -> None:
    """CosSim, compression ratio and autocorrelation against sequence length."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if not scaling_results:
        print("  Skipping quality plot: no scaling results")
        return
    plt = pyplot("scaling_quality.png")
    if plt is None:
        return
    by_actual = {r["seq_len"]: r for r in scaling_results.values()}
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    for ax, spec in zip(axes, _SCALING_PANEL_SPECS):
        for field, style, label in spec["series"]:
            seq_lens, values = figdata.scaling_series(by_actual, field)
            ax.plot(seq_lens, values, style, label=label, markersize=8)
        for level, color in spec["guides"]:
            ax.axhline(y=level, color=color, linestyle="--", alpha=0.3)
        ax.set(xlabel="Sequence Length", ylabel=spec["ylabel"], title=spec["title"])
        ax.set_xscale("log")
        if any(label for _, _, label in spec["series"]):
            ax.legend()
        ax.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(output_dir / "scaling_quality.png", dpi=150, bbox_inches="tight")
    plt.close()
    print(f"  Saved: {output_dir}/scaling_quality.png")


def run_full_layer_profile(
    kv_dir: Path,
    output_dir: Path,
    epochs: int = 2000,
    backend: str | None = None,
    values_mode: str = "reference",
    synth_layers: int = 32,
    synth_seq_len: int = 2048,
    synth_heads: int = 8,
    fm_mult: float | None = None,
    verbose: bool = True,
    device: torch.device | str | None = None,
    synth_dim: int = 128,
    mesh=None,
) -> list[dict]:
    """A medium SIREN on head 0's keys and values of EVERY layer, as one batch.

    ``backend="synthetic"`` generates the cache in place when ``kv_dir`` has
    none of this recipe and geometry (``ensure_synthetic_cache``), head width
    ``synth_dim`` included: the JAX function checks the cache against width
    128 whatever it holds, and so regenerates a narrower one under its fits.
    ``mesh``: the batch's fits sharded over its ranks (``fit_batch(mesh=)``,
    as JAX's :518); every rank calls this, rank 0 generates the cache and
    writes the JSON while the others wait, and every rank returns the records.
    """
    kv_dir, output_dir = Path(kv_dir), Path(output_dir)
    device = resolve_device(device) if mesh is None else mesh_device(mesh, device)
    writer = mesh is None or mesh.get_local_rank() == 0
    if writer:
        output_dir.mkdir(parents=True, exist_ok=True)
        if backend == "synthetic":
            ensure_synthetic_cache(kv_dir, values_mode=values_mode, seq_len=synth_seq_len, num_layers=synth_layers,
                                   num_kv_heads=synth_heads, head_dim=synth_dim, verbose=verbose)
    if mesh is not None:
        barrier(mesh)
    metadata = kvstore.load_metadata(kv_dir)

    grid: list[tuple[int, str]] = []
    tensors: list[np.ndarray] = []
    for layer_idx in range(metadata.num_layers):
        if not kvstore.has_layer(kv_dir, layer_idx):
            if verbose:
                print(f"  Skipping layer {layer_idx} (not found)")
            continue
        keys, values = kvstore.load_layer(kv_dir, layer_idx)
        for kv_type, tensor in (("key", keys[0]), ("value", values[0])):
            grid.append((layer_idx, kv_type))
            tensors.append(np.asarray(tensor, dtype=np.float32))
    if not tensors:
        raise FileNotFoundError(
            f"no layer files under {kv_dir} (expected layer_00..layer_{metadata.num_layers - 1:02d})"
        )
    if verbose:
        print(f"Layer profile: {len(grid)} fits x {epochs} epochs (one batch)")
    batch = fit_batch(np.stack(tensors), MEDIUM, epochs=epochs, fm_mult=fm_mult, device=device, mesh=mesh)
    if verbose:
        print(f"  done in {batch.train_time_seconds:.1f}s ({batch.seconds_per_fit:.3f} s/fit)")

    results = [
        {
            "layer": layer_idx,
            "kv_type": kv_type,
            "final_cosine_mean": float(batch.cosine_mean[i]),
            "compression_ratio": float(
                metadata.seq_len * metadata.head_dim * 2 / (MEDIUM.num_parameters(metadata.head_dim) * 4)
            ),
            **({"fm_mult": fm_mult} if fm_mult is not None else {}),
        }
        for i, (layer_idx, kv_type) in enumerate(grid)
    ]
    if verbose:
        for r in results:
            print(f"  L{r['layer']}_{r['kv_type']}: CosSim={r['final_cosine_mean']:.4f}")
    if writer:
        with open(output_dir / "full_layer_profile.json", "w") as f:
            json.dump(results, f, indent=2)
    if mesh is not None:
        barrier(mesh)
    return results


def plot_full_layer_profile(results: list[dict], output_dir: Path) -> None:
    """CosSim against layer index, key dips and the value peak annotated."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    plt = pyplot("full_layer_profile.png")
    if plt is None:
        return
    key_results = [r for r in results if r["kv_type"] == "key"]
    val_results = [r for r in results if r["kv_type"] == "value"]
    key_layers = [r["layer"] for r in key_results]
    key_cossim = [r["final_cosine_mean"] for r in key_results]
    val_layers = [r["layer"] for r in val_results]
    val_cossim = [r["final_cosine_mean"] for r in val_results]

    fig, ax = plt.subplots(figsize=(12, 6))
    ax.plot(key_layers, key_cossim, "bo-", label="Keys", markersize=6, linewidth=1.5)
    ax.plot(val_layers, val_cossim, "rs-", label="Values", markersize=6, linewidth=1.5)
    ax.fill_between(key_layers, key_cossim, val_cossim, alpha=0.1, color="gray")
    ax.axhline(y=0.95, color="green", linestyle="--", alpha=0.3, label="0.95 target")
    key_arr = np.array(key_cossim)
    for i in figdata.local_minima(key_arr):
        layer = key_layers[i]
        ax.annotate(f"L{layer}\n{key_arr[i]:.3f}", xy=(layer, key_arr[i]), fontsize=8, color="#3498db",
                    xytext=(layer + 1.5, key_arr[i] - 0.03),
                    arrowprops=dict(arrowstyle="->", color="#3498db", alpha=0.7))
    if val_cossim:
        val_arr = np.array(val_cossim)
        peak_idx = int(np.argmax(val_arr))
        ax.annotate(f"L{val_layers[peak_idx]} peak\n{val_arr[peak_idx]:.3f}",
                    xy=(val_layers[peak_idx], val_arr[peak_idx]), fontsize=8, color="#e74c3c",
                    xytext=(val_layers[peak_idx] + 2, val_arr[peak_idx] + 0.04),
                    arrowprops=dict(arrowstyle="->", color="#e74c3c", alpha=0.7))
    ax.set(xlabel="Layer Index", ylabel="Cosine Similarity (medium SIREN)",
           title="All Layers: Non-Monotonic Key Dips, Mid-Layer Value Peak")
    ax.set_xticks(range(0, max(key_layers) + 1, 2))
    ax.legend(fontsize=10)
    ax.grid(True, alpha=0.3)
    ax.set_ylim(0.4, 1.0)
    plt.tight_layout()
    plt.savefig(output_dir / "full_layer_profile.png", dpi=150, bbox_inches="tight")
    plt.close()
    print(f"  Saved: {output_dir}/full_layer_profile.png")
