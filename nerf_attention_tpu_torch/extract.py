"""Stage 1 of the study, the KV-cache extraction CLI (``nerf_attention_tpu/extract.py``).

    python -m nerf_attention_tpu_torch.extract --synthetic --output_dir results/kv_cache
    python -m nerf_attention_tpu_torch.extract --backend jax --model /path/to/checkpoint --seq_len 2048
    python -m nerf_attention_tpu_torch.extract --backend hf --model /path/to/checkpoint

Three backends write the kvstore layout every later stage reads:

* ``synthetic``: the deterministic signal cache (``synthetic.generate_synthetic_kv``),
  to ``--output_dir`` as given;
* ``jax``: the JAX package's own-prefill path (``extract_kv_cache_jax``): the
  sample text tokenized by the port's reader of the checkpoint's
  ``tokenizer.json`` (``io/tokenizer.py``), one bf16 prefill through
  ``models/llama.extract_kv_with_llama``, or ``models/mla.extract_kv_with_mla``
  for a DeepSeek V2/V3 directory (``config.json``'s ``model_type``; K/V,
  ``latents.npy`` and ``metadata.v_head_dim``);
* ``hf``: the JAX package's transformers path in its no-``bitsandbytes``
  branch (neither machine has ``bitsandbytes``, so no NF4): the checkpoint at
  its own dtype (``config.json``'s), through the port's loaders and prefill,
  the cache written as ``save_torch_cache`` writes a transformers cache (for
  DeepSeek: K and V at their own widths, no ``v_head_dim``, no latents, as
  transformers' cache gives them).

``--model`` must be a local checkpoint directory: there is no network, and a
hub name does not resolve. ``--mesh sp`` runs the jax backend's prefill
sequence-parallel over a fit mesh (``models/llama.llama_prefill_kv_sp``),
``--mesh tp`` tensor-parallel (``models/llama.shard_llama_params``: each rank
reads the checkpoint on the host and puts its heads' and FFN columns' weights
on its device); one NCCL rank a visible card (or torchrun's ranks), or
``--mesh_ranks`` Gloo ranks with ``--device cpu``; rank 0 writes.
``--mesh pp|ep`` wait for ``ROADMAP.md`` queue 8 and are refused, and so is
any mesh for an MLA checkpoint, as in JAX.
``--device`` resolves as every other CLI's does (the GPU unless ``--device
cpu``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from nerf_attention_tpu_torch.io import kvstore
from nerf_attention_tpu_torch.io.safetensors import DTYPES, read_header
from nerf_attention_tpu_torch.models.llama import (
    extract_kv_with_llama,
    llama_prefill_kv,
    load_for_extraction,
    load_llama_params,
)
from nerf_attention_tpu_torch.models.mla import extract_kv_with_mla, is_mla_checkpoint, load_mla_params, mla_prefill_kv
from nerf_attention_tpu_torch.parallel.mesh import run_on_mesh
from nerf_attention_tpu_torch.reference_data import load_reference_sample_text
from nerf_attention_tpu_torch.synthetic import generate_synthetic_kv
from nerf_attention_tpu_torch.types import KVMetadata
from nerf_attention_tpu_torch.utils.device import resolve_device

# Under the reference's public name.
extract_kv_cache_synthetic = generate_synthetic_kv


def get_sample_text() -> str:
    """Mixed narrative + code + technical text exercising diverse attention.

    The reference checkout's own sample text when it is mounted (the data the
    extraction results depend on), else this original text, repeated 3x to
    fill long contexts. Equal to the JAX package's, character for character.
    """
    reference_text = load_reference_sample_text()
    if reference_text is not None:
        return reference_text
    narrative = """
Long documents stress a transformer's memory in a very particular way. A
contract, for instance, establishes its defined terms in the first pages and
then leans on them for hundreds of paragraphs: the model reading clause 9.4
must still attend sharply to the definition of "Effective Date" given in
clause 1.2, thousands of tokens earlier. These references are sparse and
spiky — nothing like the smooth local correlations of natural images — and
they are exactly what a key-value cache preserves. Every token's key and
value vector is kept so that any later query can reach back to it.

The cost of that guarantee grows linearly with context. Each decoded token
must re-read the entire cache from high-bandwidth memory, and at long
contexts the accelerator spends most of its time waiting on memory rather
than computing. The question this pipeline studies is whether the cache's
contents are structured enough, as a function of position, to be replaced by
a small continuous network evaluated on demand.
"""
    code = '''
def scaled_dot_attention(q, k, v, mask=None):
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (q @ k.swapaxes(-2, -1)) * scale
    if mask is not None:
        logits = jnp.where(mask, logits, -1e9)
    weights = jax.nn.softmax(logits, axis=-1)
    return weights @ v, weights

class CachedAttention:
    """Decode-time attention over an explicit KV cache."""

    def __init__(self, num_heads, head_dim):
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.k_cache = []
        self.v_cache = []

    def step(self, q_t, k_t, v_t):
        self.k_cache.append(k_t)
        self.v_cache.append(v_t)
        k = jnp.stack(self.k_cache, axis=-2)
        v = jnp.stack(self.v_cache, axis=-2)
        out, _ = scaled_dot_attention(q_t, k, v)
        return out

def positional_spectrum(cache_slice):
    seq_len, d_head = cache_slice.shape
    spectra = []
    for dim in range(d_head):
        amplitude = np.abs(np.fft.rfft(cache_slice[:, dim]))
        spectra.append(amplitude)
    return np.stack(spectra)
'''
    technical = """
Arithmetic intensity decides everything at serving time. A TPU v5e chip pairs
roughly 197 bf16 TFLOPS with 819 GB/s of HBM bandwidth, so a kernel needs on
the order of 240 floating point operations per byte loaded before the matrix
units stop starving. Attention over a cached context performs about two
operations per element read — three orders of magnitude short. For a 100K
token context on an 8-KV-head model with 128-dim heads and 80 layers, the
cache weighs in around 32 GB in fp16: reading it once per decode step costs
milliseconds while the arithmetic costs microseconds. Quantized caches,
token eviction, windowed attention, and learned low-rank summaries all trade
recall for bandwidth; an implicit positional network would instead trade
memory traffic for compute, which only pays off if the network is far
smaller than the cache and its evaluation saturates the matrix units.
"""
    return (narrative + code + technical) * 3


def _torch_cache_layers(past_kv) -> list[tuple]:
    """Normalize any transformers cache layout to [(keys, values), ...]: v5
    ``.layers[i].keys/.values``, v4 DynamicCache ``.key_cache/.value_cache``,
    and the legacy tuple of tuples."""
    if hasattr(past_kv, "layers"):
        return [(layer.keys, layer.values) for layer in past_kv.layers]
    if hasattr(past_kv, "key_cache"):
        return list(zip(past_kv.key_cache, past_kv.value_cache))
    return [(layer[0], layer[1]) for layer in past_kv]


def save_torch_cache(past_kv, output_dir: Path, model_name: str, actual_tokens: int) -> KVMetadata:
    """Persist a transformers KV cache ((1, H, S, D) tensors per layer) in the kvstore layout, as float32.

    Duck-typed over the three layouts (this module imports no ``transformers``);
    the hf backend hands it the port's prefill as the legacy tuple layout.
    """
    layers = _torch_cache_layers(past_kv)
    num_layers = len(layers)
    _, num_kv_heads, cache_seq_len, head_dim = layers[0][0].shape
    print(f"KV cache: {num_layers} layers, {num_kv_heads} heads, seq_len={cache_seq_len}, head_dim={head_dim}")
    for layer_idx, (keys, values) in enumerate(layers):
        kvstore.save_layer(output_dir, layer_idx, keys.squeeze(0).float().cpu().numpy(),
                           values.squeeze(0).float().cpu().numpy())
    metadata = KVMetadata(model_name=model_name, num_layers=num_layers, num_kv_heads=int(num_kv_heads),
                          seq_len=int(cache_seq_len), head_dim=int(head_dim), actual_tokens=int(actual_tokens))
    kvstore.save_metadata(output_dir, metadata)
    print(f"Saved {num_layers} layers to {output_dir}/")
    return metadata


def require_local_model(model) -> Path:
    """``--model`` as a local checkpoint directory; a hub name is refused (no network: it cannot resolve)."""
    path = Path(model)
    if not path.is_dir():
        raise FileNotFoundError(f"--model {str(model)!r} is not a local checkpoint directory: the port reads HF "
                                "checkpoints from disk (config.json, *.safetensors, tokenizer.json) and downloads "
                                "nothing, so a hub name does not resolve")
    return path


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def checkpoint_dtype(model_dir) -> torch.dtype:
    """The dtype transformers' ``torch_dtype="auto"`` loads a checkpoint at: ``config.json``'s ``dtype`` (or
    ``torch_dtype``), else that of its first floating tensor. A directory without ``config.json`` is left to the
    loader to refuse, after the tokenizer (which ``load_for_extraction`` reads first)."""
    path = Path(model_dir) / "config.json"
    config = json.loads(path.read_text()) if path.is_file() else {}
    name = config.get("dtype") or config.get("torch_dtype")
    if name is not None:
        if name not in _TORCH_DTYPES:
            raise ValueError(f"{model_dir}/config.json: dtype {name!r} is not one the port loads")
        return _TORCH_DTYPES[name]
    for shard in sorted(path.parent.glob("*.safetensors")):
        for entry in read_header(shard)[0].values():
            if entry["dtype"] in DTYPES:
                return DTYPES[entry["dtype"]]
    return torch.float32


def extract_with_hf(model_name, text: str, seq_len: int, output_dir: Path, state: dict | None = None,
                    device=None) -> KVMetadata:
    """One hf-backend extraction: the JAX ``load_hf_model`` (:118) without bitsandbytes, at the checkpoint's own
    dtype through the port's loaders; tokenize (at most ``seq_len`` ids), prefill, persist as ``save_torch_cache``.

    The single implementation behind the CLI and the scaling / multi-prompt
    loops, which pass a shared ``state`` so the model loads once
    (``models/llama.load_for_extraction``).
    """
    device = resolve_device(device)
    mla = is_mla_checkpoint(model_name)
    dtype = checkpoint_dtype(model_name)
    print(f"hf backend: {model_name} at its own dtype, {dtype} (no bitsandbytes; full-precision)")
    state = load_for_extraction(model_name, dtype, device, state, load_mla_params if mla else load_llama_params)
    ids = np.asarray(state["tokenizer"](text, max_length=seq_len, truncation=True)["input_ids"])
    print(f"Sequence length: {len(ids)} tokens")
    keys, values = (mla_prefill_kv if mla else llama_prefill_kv)(state["config"], state["params"], ids)
    return save_torch_cache([(k[None], v[None]) for k, v in zip(keys, values)], Path(output_dir), model_name,
                            len(ids))


def extract_kv_cache(model_name, seq_len: int, output_dir: Path, device=None, text: str | None = None) -> KVMetadata:
    """The hf backend on the sample text (or ``text``): the JAX ``extract_kv_cache`` (:182)."""
    return extract_with_hf(model_name, text if text is not None else get_sample_text(), seq_len, output_dir,
                           device=device)


def refuse_mla_mesh(model_dir) -> None:
    """JAX's rule: an MLA checkpoint's extraction runs on one device."""
    if is_mla_checkpoint(model_dir):
        raise NotImplementedError("mesh-sharded extraction is not implemented for the MLA family "
                                  "(deepseek_v2/v3): run single-device")


def extract_kv_cache_jax(model_dir, seq_len: int, output_dir: Path, text: str | None = None,
                         state: dict | None = None, device=None, seq_mesh=None, mesh=None) -> KVMetadata:
    """The jax backend (the JAX ``extract_kv_cache_jax``, :255): a DeepSeek V2/V3 directory goes to the MLA
    extractor, every other to the Llama one, in bf16. ``state`` shares one load across calls. ``seq_mesh``: the
    Llama prefill sequence-parallel over its ranks, ``mesh`` tensor-parallel (each rank calls this); an MLA
    checkpoint refuses both."""
    text = text if text is not None else get_sample_text()
    if seq_mesh is not None or mesh is not None:
        refuse_mla_mesh(model_dir)
    if is_mla_checkpoint(model_dir):
        return extract_kv_with_mla(model_dir, seq_len=seq_len, output_dir=Path(output_dir), text=text, state=state,
                                   device=device)
    return extract_kv_with_llama(model_dir, seq_len=seq_len, output_dir=Path(output_dir), text=text, state=state,
                                 device=device, seq_mesh=seq_mesh, mesh=mesh)


def _extract_rank(mesh, model_dir, seq_len: int, output_dir: Path, kind: str) -> None:
    """One rank of ``--mesh sp`` or ``--mesh tp``."""
    extract_kv_cache_jax(model_dir, seq_len, output_dir, **{"seq_mesh" if kind == "sp" else "mesh": mesh})


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Extract KV cache")
    parser.add_argument("--model", type=str, default="meta-llama/Llama-3.1-8B",
                        help="a local HF checkpoint directory (hf and jax backends)")
    parser.add_argument("--seq_len", type=int, default=2048)
    parser.add_argument("--output_dir", type=str, default="results/kv_cache")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--backend", type=str, default="hf", choices=["hf", "jax", "synthetic"])
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="torch device (cuda without a GPU is an error; cpu only when asked for)")
    parser.add_argument("--values_mode", type=str, default="reference", choices=["reference", "hard"],
                        help="synthetic values recipe: 'reference' (smooth sine parity) or 'hard' "
                        "(attention-sharpened, reproduces the real K>>V gap)")
    parser.add_argument("--mesh", type=str, default=None, choices=["tp", "sp", "pp", "ep"],
                        help="jax backend only: shard the prefill over a fit mesh; 'sp' shards the token axis "
                        "(sequence parallel, the long-context path), 'tp' the weights (Megatron tensor parallel); "
                        "pp and ep are not ported (ROADMAP.md queue 8)")
    parser.add_argument("--mesh_ranks", type=int, default=None,
                        help="ranks of the --mesh (default: every visible card; required with --device cpu)")
    args = parser.parse_args(argv)

    synthetic = args.synthetic or args.backend == "synthetic"
    if args.mesh in ("pp", "ep"):
        raise NotImplementedError(f"--mesh {args.mesh} is not ported to PyTorch: the pipeline- and expert-parallel "
                                  "prefills wait for ROADMAP.md queue 8; run it with python -m "
                                  "nerf_attention_tpu.extract")
    if args.mesh is not None and (synthetic or args.backend != "jax"):
        raise ValueError(f"--mesh {args.mesh} shards the jax backend's prefill: pass --backend jax")
    if not synthetic:
        require_local_model(args.model)
    if args.mesh is not None:
        refuse_mla_mesh(args.model)  # before the ranks start
        run_on_mesh(_extract_rank, args.model, args.seq_len, Path(args.output_dir), args.mesh,
                    world_size=args.mesh_ranks, device=args.device)
        return
    device = resolve_device(args.device)
    if synthetic:
        # --output_dir as given (the reference appends '_synthetic'), so extract --synthetic and the later
        # stages' --kv_dir compose without a rename.
        generate_synthetic_kv(seq_len=args.seq_len, output_dir=Path(args.output_dir), values_mode=args.values_mode)
    elif args.backend == "jax":
        extract_kv_cache_jax(args.model, args.seq_len, Path(args.output_dir), device=device)
    else:
        extract_kv_cache(args.model, args.seq_len, Path(args.output_dir), device=device)


if __name__ == "__main__":
    main()
