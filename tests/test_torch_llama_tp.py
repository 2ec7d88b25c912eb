"""Megatron tensor parallelism of the Llama (``models/llama.shard_llama_params``) on Gloo worlds of 2 and 4 CPU ranks.

Every rank runs its query heads, its KV heads (split over 2 ranks, each
replicated on 2 of 4 ranks where the 2 KV heads are fewer than the ranks)
and its FFN columns; the forward sums the sublayers' partial outputs over
the ranks (``parallel.mesh.all_reduce_sum``) and gathers K/V and the per-head
outputs over heads. One world a size computes every case once
(``tests/torch_mesh_ranks.tp_forwards``, spawned ranks that import no JAX);
the JAX side runs in this process, its sharded calls on the conftest's
8-device CPU mesh.

The cases: all 18 families at ``tests/test_llama_jax.py``'s
``_FAMILY_SMOKE_DICTS`` geometry (4 query / 2 KV heads) with norm weights
drawn around 1 (std 0.3) and nonzero biases, the prefill, the decode step
(both captures) and the rollout held to JAX's unsharded calls on the same
weights (``interop.llama_params_from_jax``); the configurations JAX's TP
tests run (``tests/test_llama_jax.py:155, 586, 1599, 1996, 2031, 2070`` and
``__graft_entry__.py:253-335``) held to JAX's own sharded call; the
layout, the refusals, a batched decode step, and the TP extraction.

Tolerance: fp32, atol 1e-5 / rtol 1e-5 against JAX (the bar JAX holds its
own TP to is atol 1e-4, ``tests/test_llama_jax.py:170``; the ranks sum
partial products in another order than one matmul does, measured up to
~2e-6 here). Every sum over the ranks comes out the same bits on every
rank, asserted after each one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from nerf_attention_tpu.io import kvstore as jax_kvstore
from nerf_attention_tpu.models import llama_jax
from nerf_attention_tpu_torch.interop import llama_params_from_jax
from nerf_attention_tpu_torch.io import kvstore
from nerf_attention_tpu_torch.models import llama
from nerf_attention_tpu_torch.parallel import mesh as port_mesh
from test_llama_jax import _FAMILY_SMOKE_DICTS, TINY_HF_KWARGS
import torch_mesh_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
TOL = dict(atol=1e-5, rtol=1e-5)
FAMILIES = sorted(_FAMILY_SMOKE_DICTS)
SEQ, POSITION = 12, 8  # prefill 12 tokens; the step at 8 over rows [0, 8); the rollout of tokens 8-11


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


def _family_config(model_type: str):
    d = {"model_type": model_type, "vocab_size": 64, "hidden_size": 16, "intermediate_size": 32,
         "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 4,
         "max_position_embeddings": 64, **_FAMILY_SMOKE_DICTS[model_type]}
    return llama.LlamaConfig.from_hf_dict(d), llama_jax.LlamaConfig.from_hf_dict(d)


def _biting(jparams: dict, seed: int) -> dict:
    """JAX's params with every norm weight redrawn around 1 (std 0.3) and every bias nonzero (std 0.05), so the
    flat and per-head norms and the biases change the outputs."""
    rng = np.random.RandomState(seed)
    layers = {}
    for name, x in jparams["layers"].items():
        x = np.asarray(x)
        if "norm" in name:
            x = (1.0 + 0.3 * rng.randn(*x.shape)).astype(np.float32)
        elif name.endswith("bias"):
            x = (0.05 * rng.randn(*x.shape)).astype(np.float32)
        layers[name] = jnp.asarray(x)
    return {"embed": jparams["embed"], "layers": layers}


def _jax_serving(jcfg, jparams, ids, position, mesh=None):
    """JAX's prefill, decode step at ``position`` (both captures) and rollout of ids[position:], as the port's rank
    program runs them; with ``mesh``, on Megatron-sharded weights and a head-sharded cache, as
    ``__graft_entry__.py:253-335`` runs them."""
    params = jparams if mesh is None else llama_jax.shard_llama_params(jparams, mesh)
    place = (lambda x: x) if mesh is None else (
        lambda x: jax.device_put(x, NamedSharding(mesh, PartitionSpec(None, "tp", None, None))))
    keys, values = llama_jax.llama_prefill_kv(jcfg, params, jnp.asarray(ids))
    step = llama_jax.llama_decode_step(jcfg, params, jnp.int32(ids[position]), jnp.int32(position),
                                       place(keys[:, :, :position]), place(values[:, :, :position]),
                                       capture_ffn_input=True, capture_sink_mass=True)
    kept = (jnp.arange(len(ids)) < position)[None, None, :, None]
    hs, filled, rows, ent = llama_jax.llama_decode_rollout(
        jcfg, params, jnp.asarray(ids[position:]), jnp.int32(position), place(jnp.where(kept, keys, 0.0)),
        place(jnp.where(kept, values, 0.0)))
    as_np = lambda xs: [np.asarray(x) for x in xs]
    return dict(prefill=as_np((keys, values)), step=as_np((step[0], *step[1], *step[2:])),
                rollout=as_np((hs, *filled, *rows, ent)))


# ---- the configurations of JAX's TP tests: HF checkpoints built as tests/test_llama_jax.py builds them ----

def _hf_llama(tmp):
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(**TINY_HF_KWARGS))


def _hf_mixtral(tmp):
    torch.manual_seed(11)
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2, max_position_embeddings=64,
        tie_word_embeddings=True))


def _hf_with_qk_norms(config_cls, model_cls, seed, **kw):
    def build(tmp):
        torch.manual_seed(seed)
        model = model_cls(config_cls(**{"vocab_size": 128, **kw}, hidden_size=32, intermediate_size=64,
                                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                                     max_position_embeddings=64))
        with torch.no_grad():
            for layer in model.model.layers:
                layer.self_attn.q_norm.weight.normal_(mean=1.0, std=0.3)
                layer.self_attn.k_norm.weight.normal_(mean=1.0, std=0.3)
        return model
    return build


def _hf_glm(family):
    def build(tmp):
        cfg_cls, model_cls = ((transformers.GlmConfig, transformers.GlmForCausalLM) if family == "glm"
                              else (transformers.Glm4Config, transformers.Glm4ForCausalLM))
        torch.manual_seed(37)
        model = model_cls(cfg_cls(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                                  head_dim=8, pad_token_id=0, attn_implementation="eager"))
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
                    proj.bias.normal_(std=0.05)
        return model
    return build


JAX_TP = {  # name: (tp, the HF model it makes, ids), tests/test_llama_jax.py's TP tests in their order
    "tiny_llama_tp4": (4, _hf_llama, [5, 3, 8, 1, 2, 99]),
    "mixtral_intermediate_split_tp4": (4, _hf_mixtral, [1, 2, 3, 4, 5, 6, 7, 8]),
    "olmo2_tp2": (2, _hf_with_qk_norms(transformers.Olmo2Config, transformers.Olmo2ForCausalLM, 23),
              [5, 3, 8, 1, 2, 99]),
    "cohere_tp2": (2, _hf_with_qk_norms(transformers.CohereConfig, transformers.CohereForCausalLM, 29, vocab_size=96,
                                    use_qk_norm=True), [5, 3, 8, 1, 2, 77]),
    "cohere_nondividing_kv_tp4": (4, _hf_with_qk_norms(transformers.CohereConfig, transformers.CohereForCausalLM, 31,
                                                   vocab_size=96, use_qk_norm=True), [5, 3, 8, 1, 2, 77]),
    "glm_tp2": (2, _hf_glm("glm"), [3, 17, 42, 9, 9, 57]),
    "glm4_tp2": (2, _hf_glm("glm4"), [3, 17, 42, 9, 9, 57]),
}
JAX_POSITION = 4  # the HF configurations' step and rollout (6 or 8 ids)


def _graft_config(n: int) -> dict:
    """``__graft_entry__.py:253-335``'s TP configuration on n devices."""
    return dict(vocab_size=64, hidden_size=8 * n, intermediate_size=16 * n, num_hidden_layers=2,
                num_attention_heads=n, num_key_value_heads=n, head_dim=8)


def _tp_mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("tp",))


BATCH_FAMILY = "gpt_oss"  # sinks, biases, replicated experts: the batched step's configuration


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world size's rank-0 results, the JAX references of each case, and the directory the TP extraction
    wrote."""
    families = {}
    for model_type in FAMILIES:
        cfg, jcfg = _family_config(model_type)
        jparams = _biting(llama_jax.init_random_llama(jcfg, seed=3), seed=4)
        ids = np.random.RandomState(11).randint(0, 64, SEQ).astype(np.int32)
        families[model_type] = (cfg, llama_params_from_jax(jparams), ids, _jax_serving(jcfg, jparams, ids, POSITION))
    jax_tp = {}
    for name, (tp, build, ids) in JAX_TP.items():
        checkpoint = tmp_path_factory.mktemp(name)
        build(checkpoint).save_pretrained(checkpoint, safe_serialization=True)
        jcfg, jparams = llama_jax.load_llama_params(checkpoint, dtype=jnp.float32)
        cfg = llama.LlamaConfig(**dataclasses.asdict(jcfg))
        ids = np.asarray(ids, np.int32)
        want = llama_jax.llama_prefill_kv(jcfg, llama_jax.shard_llama_params(jparams, _tp_mesh(tp)),
                                          jnp.asarray(ids))
        single = _jax_serving(jcfg, jparams, ids, JAX_POSITION)
        jax_tp[name] = (tp, cfg, llama_params_from_jax(jparams), ids, [np.asarray(x) for x in want], single)

    out = {}
    for world in WORLDS:
        graft = _graft_config(world)
        gcfg, jgcfg = llama.LlamaConfig(**graft), llama_jax.LlamaConfig(**graft)
        gparams = llama_jax.init_random_llama(jgcfg)
        gids = np.arange(16, dtype=np.int32)
        graft_want = _jax_serving(jgcfg, gparams, gids, 12, mesh=_tp_mesh(world))
        cases = [(m, cfg, params, ids, POSITION, *ref["prefill"]) for m, (cfg, params, ids, ref) in families.items()]
        cases += [(name, cfg, params, ids, JAX_POSITION, *single["prefill"])
                  for name, (tp, cfg, params, ids, _, single) in jax_tp.items() if tp == world]
        cases.append(("graft", gcfg, llama_params_from_jax(gparams), gids, 12, *graft_want["prefill"]))

        cfg, params, ids, _ = families[BATCH_FAMILY]
        keys, values = llama.llama_prefill_kv(cfg, params, ids)
        caches = [torch.stack([x, 0.5 * x, -x]).numpy() for x in (keys, values)]  # (3, L, n_kv, S, D)
        batched = (cfg, params, ids[[3, 7, 9]].copy(), np.array([5, 8, 10]), *caches)
        written = tmp_path_factory.mktemp(f"tp{world}") / "kv"
        extraction = (cfg, params, ids, written)
        result = port_mesh.run_on_mesh(torch_mesh_ranks.tp_forwards, cases, batched, extraction, world_size=world,
                                       device="cpu")
        out[world] = dict(result=result, written=written, graft=graft_want)
    return dict(worlds=out, families=families, jax_tp=jax_tp)


# ---- all 18 families against JAX's unsharded calls ----

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_prefill(worlds, world, family):
    """The whole (L, n_kv, S, D) K/V on every rank, gathered over heads, as JAX's unsharded prefill gives it."""
    got, want = worlds["worlds"][world]["result"][family]["prefill"], worlds["families"][family][3]["prefill"]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 2, SEQ, 4)
        _close(g, w, family)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_decode_step(worlds, world, family):
    """h (whole on every rank), the new K/V and the entropies gathered over heads, the FFN input and the sink
    mass, as JAX's unsharded step gives them."""
    got, want = worlds["worlds"][world]["result"][family]["step"], worlds["families"][family][3]["step"]
    for name, g, w in zip(("h", "k_new", "v_new", "entropy", "ffn_x", "sink mass"), got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        _close(g, w, f"{family} {name}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_rollout(worlds, world, family):
    """The rollout from each rank's shard of the buffers: h, the filled buffers (gathered once, at the end), each
    step's rows and the entropies, as JAX's unsharded rollout gives them; the filled rows are the prefill's."""
    got, ref = worlds["worlds"][world]["result"][family]["rollout"], worlds["families"][family][3]
    for name, g, w in zip(("h", "keys", "values", "k_new", "v_new", "entropy"), got, ref["rollout"]):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        _close(g, w, f"{family} {name}")
    _close(got[1], ref["prefill"][0], f"{family} filled keys against the prefill")
    _close(got[2], ref["prefill"][1], f"{family} filled values against the prefill")


# ---- the configurations of JAX's TP tests, against JAX's own sharded call ----

@pytest.mark.parametrize("name", list(JAX_TP))
def test_jax_tp_configuration(worlds, name):
    """tests/test_llama_jax.py's TP tests at their tp: the port's TP prefill within TOL of JAX's sharded prefill,
    and its step and rollout of JAX's unsharded ones (JAX's tests hold those only unsharded)."""
    tp, *_, want, single = worlds["jax_tp"][name]
    got = worlds["worlds"][tp]["result"][name]
    for g, w in zip(got["prefill"], want):
        _close(g, w, f"{name} prefill")
    for part in ("step", "rollout"):
        for g, w in zip(got[part], single[part]):
            _close(g, w, f"{name} {part}")


@pytest.mark.parametrize("world", WORLDS)
def test_graft_entry_tp_section(worlds, world):
    """``__graft_entry__.py:253-335`` at n = world: the prefill, the step at position 12 (over a head-sharded
    cache in JAX) and the 4-token rollout, against JAX's sharded calls; the rollout refills the prefill's rows."""
    got, want = worlds["worlds"][world]["result"]["graft"], worlds["worlds"][world]["graft"]
    for part in ("prefill", "step", "rollout"):
        for g, w in zip(got[part], want[part]):
            _close(g, w, f"graft {part}")
    assert got["prefill"][0].shape == (2, world, 16, 8)
    _close(got["rollout"][1], want["prefill"][0], "filled keys against the prefill")


# ---- the layout ----

@pytest.mark.parametrize("world", WORLDS)
def test_every_sum_is_the_same_bits_on_every_rank(worlds, world):
    """After every all_reduce_sum of every case, and for the step's and the rollout's h, every rank holds rank
    0's bits. A Llama layer sums once a sublayer: 2 layers x 2 in the prefill, the step and each of the 4 rollout
    steps."""
    result = worlds["worlds"][world]["result"]
    for rank, same in enumerate(result["same bits"]):
        assert all(same.values()), (rank, [k for k, v in same.items() if not v])
    assert result["llama"]["reduces"] == (2 + SEQ - POSITION) * 2 * 2


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_heads_and_columns(worlds, world):
    """gpt_oss's layout (4 query heads, 2 KV heads, hidden 16, 4 experts): each rank's query heads and its KV
    heads, split over 2 ranks and each replicated on 2 of 4; q / k / v / o, sinks and biases cut at head
    boundaries, o_bias, norms, router and the (replicated) experts whole."""
    layouts = worlds["worlds"][world]["result"]["layouts"]
    n_q, replicas = 4 // world, max(1, world // 2)
    for rank, layout in enumerate(layouts):
        kv0 = rank // replicas if replicas > 1 else rank * (2 // world)
        kv_per = 1
        assert layout["q_heads"] == (rank * n_q, (rank + 1) * n_q)
        assert layout["kv_heads"] == (kv0, kv0 + kv_per) and layout["kv_replicas"] == replicas
        shapes = layout["shapes"]
        assert shapes["q"] == (16, 4 * n_q) and shapes["o"] == (4 * n_q, 16) and shapes["sinks"] == (n_q,)
        assert shapes["k"] == shapes["v"] == (16, 4 * kv_per) and shapes["k_bias"] == (4 * kv_per,)
        assert shapes["o_bias"] == shapes["input_norm"] == (16,) and shapes["router"] == (16, 4)
        assert shapes["gate_up"] == (4, 16, 64) and shapes["moe_down_bias"] == (4, 16)


REFUSALS = {  # name: (world 2's refusal, world 4's); None: not refused
    "expert_axis on a MoE": ("NotImplementedError: expert parallelism",) * 2,
    "expert_axis on a dense model": ("ValueError: expert_axis given but the checkpoint has no MoE leaves",) * 2,
    "5 query heads": ("query head count 5 not divisible by mesh size 2",
                      "query head count 5 not divisible by mesh size 4"),
    "3 KV heads": ("3 KV heads neither divide over 2 ranks", "3 KV heads neither divide over 4 ranks"),
    "another rank's weights": ("Llama weights sharded for rank",) * 2,
    "another rank's cache": ("a shard of rank",) * 2,
    "SP on TP weights": ("SP and TP are mutually exclusive",) * 2,
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(worlds, world, case):
    """Expert parallelism (not ported; JAX's error on a dense model), query heads that do not divide over the
    ranks, KV heads that neither divide over them nor divide their count, weights or a cache shard made for
    another rank, and SP over TP weights raise before anything is computed."""
    message = worlds["worlds"][world]["result"]["refusals"][case]
    assert REFUSALS[case][WORLDS.index(world)] in message, message


@pytest.mark.parametrize("world", WORLDS)
def test_batched_decode_step(worlds, world):
    """Three tokens at their own positions over three caches (*B = 3), both captures: the TP step equals the
    unsharded one, from the global caches and from each rank's shard of them alike (bit for bit)."""
    got = worlds["worlds"][world]["result"]["batched"]
    assert got["shards_equal"]
    for name, g, w in zip(("h", "k_new", "v_new", "entropy", "ffn_x", "sink mass"), got["tp"], got["unsharded"]):
        assert g.shape == w.shape and g.shape[0] == 3, (name, g.shape, w.shape)
        _close(g, w, name)


@pytest.mark.parametrize("world", WORLDS)
def test_batched_rollout_with_forced_rows(worlds, world):
    """A rollout over three caches (*B = 3) with forced K/V rows: the TP rollout equals the unsharded one, and the
    buffers hold the forced rows, bit for bit, where the steps wrote them."""
    got = worlds["worlds"][world]["result"]["batched rollout"]
    for name, g, w in zip(("h", "keys", "values", "k_new", "v_new", "entropy"), got["tp"], got["unsharded"]):
        assert g.shape == w.shape and g.shape[0] == 3, (name, g.shape, w.shape)
        _close(g, w, name)
    start = got["start"]
    for buffer, forced in zip(got["tp"][1:3], got["forced"]):
        steps = forced.shape[1]
        np.testing.assert_array_equal(buffer[:, :, :, start:start + steps], np.moveaxis(forced[..., 0, :], 1, 3))


@pytest.mark.parametrize("world", WORLDS)
def test_rollout_into_global_buffers(worlds, world):
    """Given the global buffers, every rank writes its heads in place and the gathered rows land in the caller's
    buffers, which come back; bit for bit the rollout from each rank's shard."""
    got = worlds["worlds"][world]["result"]["global buffers"]
    assert got["in_place"] and got["equal"]


@pytest.mark.parametrize("world", WORLDS)
def test_prefill_and_save_kv_written_once(worlds, world, tmp_path):
    """prefill_and_save_kv with TP weights: rank 0 alone writes the layers (the others none), JAX's metadata and
    each layer's K / V within TOL of JAX's unsharded extraction."""
    result, written = worlds["worlds"][world]["result"], worlds["worlds"][world]["written"]
    assert result["writes"] == [[0, 1]] + [[]] * (world - 1)
    cfg, params, ids, _ = worlds["families"][BATCH_FAMILY]
    jcfg = _family_config(BATCH_FAMILY)[1]
    jparams = _biting(llama_jax.init_random_llama(jcfg, seed=3), seed=4)
    llama_jax.prefill_and_save_kv(jcfg, jparams, ids, tmp_path, "toy")
    assert kvstore.load_metadata(written).to_dict() == jax_kvstore.load_metadata(tmp_path).to_dict()
    for layer in range(2):
        for got, want in zip(kvstore.load_layer(written, layer), jax_kvstore.load_layer(tmp_path, layer)):
            _close(got, want, f"layer {layer}")


# ---- the CLI and the dry run ----

def test_extract_mesh_tp_writes_the_single_device_cache(tmp_path):
    """extract --backend jax --mesh tp (a tiny Llama checkpoint beside the fixture tokenizer, bf16) writes the cache
    the single-device extraction writes: the same files and metadata; K/V bit for bit on one Gloo rank, and on two
    within bf16's rounding of the partial sums (2^-7 of each layer's largest |K|, |V|)."""
    import shutil

    from nerf_attention_tpu_torch import extract
    from torch_hf_families import save_tiny
    from torch_tokenizer_fixtures import LLAMA3_DIR

    model = tmp_path / "llama"
    save_tiny("llama", model, vocab_size=4096)
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        shutil.copy(LLAMA3_DIR / name, model / name)
    argv = ["--backend", "jax", "--model", str(model), "--seq_len", "61", "--device", "cpu"]
    extract.main([*argv, "--output_dir", str(tmp_path / "single")])
    for ranks in (1, 2):
        extract.main([*argv, "--output_dir", str(tmp_path / f"tp{ranks}"), "--mesh", "tp", "--mesh_ranks", str(ranks)])
    single = kvstore.load_metadata(tmp_path / "single")
    for run in ("tp1", "tp2"):
        assert sorted(p.name for p in (tmp_path / run).iterdir()) == sorted(p.name for p in (tmp_path /
                                                                                             "single").iterdir())
        assert kvstore.load_metadata(tmp_path / run).to_dict() == single.to_dict()
    for layer in range(single.num_layers):
        want = kvstore.load_layer(tmp_path / "single", layer)
        for got, w in zip(kvstore.load_layer(tmp_path / "tp1", layer), want):
            np.testing.assert_array_equal(got, w)  # one rank: the unsharded arithmetic
        for got, w in zip(kvstore.load_layer(tmp_path / "tp2", layer), want):
            assert np.abs(got - w).max() <= 2.0**-7 * np.abs(w).max(), layer


@pytest.mark.parametrize("argv, error, match", [
    (["--backend", "jax", "--mesh", "ep"], NotImplementedError, "queue 8"),
    (["--backend", "jax", "--mesh", "tp"], NotImplementedError, "MLA"),
    (["--backend", "hf", "--mesh", "tp"], ValueError, "--backend jax"),
], ids=["ep", "mla", "not-jax"])
def test_extract_mesh_tp_refusals(tmp_path, argv, error, match):
    """--mesh ep stays refused, and --mesh tp on an MLA checkpoint or another backend than jax, before any rank
    starts or anything is written."""
    from nerf_attention_tpu_torch import extract

    model = tmp_path / "mla"
    model.mkdir()
    (model / "config.json").write_text('{"model_type": "deepseek_v2"}')
    with pytest.raises(error, match=match):
        extract.main([*argv, "--model", str(model), "--device", "cpu", "--mesh_ranks", "2",
                      "--output_dir", str(tmp_path / "kv")])
    assert not (tmp_path / "kv").exists()


def test_dryrun_multichip_on_the_cpu():
    """dryrun_multichip(2, device="cpu"): every section, the TP prefill, step and rollout among them, within its
    limits on two Gloo ranks."""
    from nerf_attention_tpu_torch.dryrun import dryrun_multichip

    gaps = dryrun_multichip(2, device="cpu")
    assert {"tp prefill", "tp decode step", "tp rollout", "tp rollout refill", "sp prefill"} <= set(gaps), gaps
    assert all(gap <= 1e-4 for name, gap in gaps.items() if name.startswith("tp")), gaps


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """Without device=, the dry run asks for the card, and without one it raises rather than run on the CPU."""
    from nerf_attention_tpu_torch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dryrun.dryrun_multichip(2)
