"""The port's extract CLI against nerf_attention_tpu/extract.py, on the CPU.

``extract --synthetic`` writes the same files byte for byte (the JAX CLI
through its numpy generator, which the port's host generator equals bit for
bit, tests/test_torch_synthkv.py); ``get_sample_text`` is the same text;
``save_torch_cache`` writes the same files from each of the three
transformers cache layouts (stand-ins built here: the module imports no
transformers). The hf and jax backends and ``--mesh`` are refused.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nerf_attention_tpu.native as jax_native
from nerf_attention_tpu import extract as jax_extract
from nerf_attention_tpu_torch import extract, synthetic

torch.set_num_threads(1)


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def jax_numpy_generator(monkeypatch):
    monkeypatch.setenv("NERF_ATTENTION_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


@pytest.mark.parametrize("flags", [["--synthetic"], ["--backend", "synthetic"]], ids=["synthetic", "backend"])
def test_synthetic_files_equal_jax(tmp_path, monkeypatch, jax_numpy_generator, flags):
    argv = [*flags, "--seq_len", "24"]
    extract.main([*argv, "--device", "cpu", "--output_dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["extract", *argv, "--output_dir", str(tmp_path / "jax")])
    jax_extract.main()
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(got) == list(want) and len(want) == 33  # 32 layers and the metadata
    assert got == want


def test_sample_text_and_synthetic_alias():
    assert extract.get_sample_text() == jax_extract.get_sample_text()
    assert extract.extract_kv_cache_synthetic is synthetic.generate_synthetic_kv


def _cache(layout: str, layers, dtype):
    """A transformers-like cache of ``layers`` [(k, v)] in one of the three layouts."""
    if layout == "v5_layers":
        return SimpleNamespace(layers=[SimpleNamespace(keys=k.to(dtype), values=v.to(dtype)) for k, v in layers])
    if layout == "v4_dynamic":
        return SimpleNamespace(key_cache=[k.to(dtype) for k, _ in layers], value_cache=[v.to(dtype) for _, v in layers])
    return tuple((k.to(dtype), v.to(dtype)) for k, v in layers)


@pytest.mark.parametrize("layout", ["v5_layers", "v4_dynamic", "legacy_tuple"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
def test_save_torch_cache_equals_jax(tmp_path, layout, dtype):
    gen = torch.Generator().manual_seed(0)
    layers = [(torch.randn(1, 2, 12, 8, generator=gen), torch.randn(1, 2, 12, 8, generator=gen)) for _ in range(3)]
    got = extract.save_torch_cache(_cache(layout, layers, dtype), tmp_path / "port", "tiny-model", 12)
    want = jax_extract.save_torch_cache(_cache(layout, layers, dtype), tmp_path / "jax", "tiny-model", 12)
    assert got.to_dict() == want.to_dict()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    k0 = np.load(tmp_path / "port" / "layer_00.npz")["keys"]
    np.testing.assert_array_equal(k0, layers[0][0][0].to(dtype).float().numpy())


@pytest.mark.parametrize("argv, error, match", [
    ([], FileNotFoundError, "not a local checkpoint directory"),  # --backend hf, --model meta-llama/Llama-3.1-8B
    (["--backend", "jax"], FileNotFoundError, "not a local checkpoint directory"),
    (["--synthetic", "--mesh", "pp"], NotImplementedError, "queue 8")], ids=["hf-default", "jax", "mesh"])
def test_refuses_what_is_not_ported(tmp_path, argv, error, match):
    """A hub name cannot resolve without a network (the default --model is one), and --mesh pp waits for queue 8:
    each is refused before anything is written. tests/test_torch_extract_text.py runs both backends."""
    with pytest.raises(error, match=match):
        extract.main([*argv, "--device", "cpu", "--output_dir", str(tmp_path / "kv")])
    assert not (tmp_path / "kv").exists()
