"""The port's continuous-batching LM engine (serve/engine.py) and launcher.

Mirrors tests/test_serve_engine.py: ragged requests scheduled through a
fixed slot pool must generate what each request generates alone through
prefill + decode, which checks cache splicing, per-slot positions and the
kv_len mask over stale rows (idle slots decode at position 0). Prompts are
longer than the reduced window (16), so the band bites. Then the port's
Engine against the reference's Engine on the same carried-across weights.

Tolerance, stated as a logit margin: the reference's bit-identical contract
rests on XLA-CPU reduction order; here a batch of one and a batch of
num_slots, or the two frameworks, may sum in another order. So each chosen
token is checked teacher-forced: its logit must be within from test_torch_models import with_qkv_biases  # noqa: E402

MARGIN = 1e-4
(f32) of the step's maximum. Where the port's and the reference's greedy
tokens differ, the first differing step must be such a near-tie in the
reference's own logits; no request is skipped. For qwen2-moe and
deepseek-v2-lite (MLA: a latent cache, spliced at the prefix layer and the
period stack) at their published capacity factor ("+cap") decode rows are coupled (a decode step's
router chunk is the whole slot batch, one slot an expert), so a flip there
is held in the reference engine's own batch geometry: its logits recorded at
the step that chose the token. The recurrent archs (reduced jamba: Mamba
layers, one attention layer, MoE; xlstm-125m: mLSTM and sLSTM blocks) splice
O(1) states whole; in the engine's own 4-row decode geometry a request
rerun alone is exact. llava-next-mistral-7b (embedding input) is served on
token prompts, as the reference's Engine serves it; whisper-base (encoder
frames) is refused by both (tests/test_torch_encdec.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_transformer
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, transformer
from repro_torch.serve.engine import Engine, Request, _splice_cache

from test_torch_models import with_qkv_biases  # noqa: E402

MARGIN = 1e-4
# (prompt length, max_new): ragged, all prompts past the window of 16
SCHEDULE = [(18, 4), (24, 3), (20, 5), (30, 2), (17, 6)]


def _cfg(variant, jax_side=False):
    """A reduced variant: "+gqa" 2 kv heads, "+cap" the MoE's published
    capacity factor (1.25)."""
    arch, _, extra = variant.partition("+")
    cfg = jax_reduce(jax_get_config(arch)) if jax_side else reduce_config(get_config(arch))
    if extra == "cap":
        cf = get_config(arch).moe.capacity_factor
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return dataclasses.replace(cfg, num_kv_heads=2) if extra == "gqa" else cfg


def _tokens_np(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _requests(cfg, schedule, seed=1):
    rng = np.random.default_rng(seed)
    return [
        Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), gen)
        for i, (n, gen) in enumerate(schedule)
    ]


def _margins(m, params, cfg, req, tokens, capacity):
    """Teacher-forced on `tokens`: per step, the step's max logit minus the
    chosen token's logit, running `req` alone (batch 1)."""
    last, caches = m.prefill(params, {"tokens": req.prompt[None]})
    caches = transformer.pad_caches(cfg, caches, capacity)
    logits, out = last[0, -1, : cfg.vocab_size], []
    for j, tok in enumerate(tokens):
        out.append(float(logits.max() - logits[tok]))
        if j + 1 < len(tokens):
            lg, caches = m.decode_step(
                params, torch.tensor([[tok]]), caches, torch.tensor([len(req.prompt) + j])
            )
            logits = lg[0, -1, : cfg.vocab_size]
    return out


@pytest.mark.parametrize("variant", ["h2o-danube-1.8b", "h2o-danube-1.8b+gqa"])
@pytest.mark.parametrize("slots", [2, 3])
def test_engine_matches_per_request(variant, slots):
    cfg = _cfg(variant)
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    reqs = _requests(cfg, SCHEDULE)
    capacity = 40
    eng = Engine(cfg, params, num_slots=slots, capacity=capacity, device="cpu")
    results = eng.run(list(reqs))
    assert sorted(results) == [r.rid for r in reqs]
    for r in reqs:
        assert len(results[r.rid]) == r.max_new
        assert max(_margins(m, params, cfg, r, results[r.rid], capacity)) <= MARGIN, r.rid
    st = eng.stats
    assert st.prefills == len(reqs)
    assert st.prefill_tokens == sum(n for n, _ in SCHEDULE)
    assert st.decode_tokens == sum(g - 1 for _, g in SCHEDULE)


def _margins_in_geometry(m, params, cfg, req, tokens, slots, capacity):
    """Teacher-forced on `tokens`: per step, the step's max logit minus the
    chosen token's, running `req` alone in the engine's decode geometry (its
    prefill spliced into slot 0 of a zeroed cache of `slots` rows, the other
    slots idle at position 0)."""
    last, seq_cache = m.prefill(params, {"tokens": req.prompt[None]})
    caches = transformer.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                                  m.cache_specs(slots, capacity))
    _splice_cache(caches, seq_cache, 0)
    step = torch.zeros((slots, 1), dtype=torch.long)
    pos = torch.zeros((slots,), dtype=torch.long)
    logits, out = last[0, -1, : cfg.vocab_size], []
    for j, tok in enumerate(tokens):
        out.append(float(logits.max() - logits[tok]))
        if j + 1 < len(tokens):
            step[0, 0], pos[0] = tok, len(req.prompt) + j
            lg, caches = m.decode_step(params, step, caches, pos)
            logits = lg[0, -1, : cfg.vocab_size]
    return out


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_recurrent_engine_matches_lone_rerun_in_its_geometry(arch):
    """The reduced recurrent archs through a 4-slot engine: each request
    rerun alone in the engine's 4-row decode geometry, teacher-forced on the
    engine's tokens, chooses every one of them (each margin 0: every decode
    op is row-wise, and jamba's MoE is dropless at reduce_config's capacity);
    alone at batch 1 each is within MARGIN of its step's top."""
    cfg = _cfg(arch)
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    reqs = _requests(cfg, SCHEDULE)
    eng = Engine(cfg, params, num_slots=4, capacity=40, device="cpu")
    results = eng.run(list(reqs))
    assert sorted(results) == [r.rid for r in reqs]
    for r in reqs:
        assert len(results[r.rid]) == r.max_new
        assert max(_margins_in_geometry(m, params, cfg, r, results[r.rid], 4, 40)) == 0.0, r.rid
        assert max(_margins(m, params, cfg, r, results[r.rid], 40)) <= MARGIN, r.rid
    assert eng.stats.decode_tokens == sum(g - 1 for _, g in SCHEDULE)


def test_more_requests_than_slots_all_served():
    cfg = reduce_config(get_config("phi4-mini-3.8b"))
    params = build_model(cfg, device="cpu").init(0)
    reqs = _requests(cfg, [(5 + i, 3) for i in range(7)])
    results = Engine(cfg, params, num_slots=3, capacity=16, device="cpu").run(list(reqs))
    assert sorted(results) == list(range(7))
    assert all(len(v) == 3 for v in results.values())


def _jax_margin_at(jm, jp, jcfg, prompt, prefix, tok, capacity):
    """The reference's own logits teacher-forced on `prefix`: the step's max
    logit minus that of `tok`."""
    last, caches = jm.prefill(jp, {"tokens": jnp.asarray(prompt)[None]})
    caches = jax_transformer.pad_caches(jcfg, caches, capacity)
    logits = last[0, -1, : jcfg.vocab_size]
    for j, t in enumerate(prefix):
        lg, caches = jm.decode_step(jp, jnp.asarray([[t]], jnp.int32), caches,
                                    jnp.asarray([len(prompt) + j], jnp.int32))
        logits = lg[0, -1, : jcfg.vocab_size]
    return float(logits.max() - logits[tok])


def _record_decode(jeng):
    """Wrap the reference engine's decode step: per step, the slots' rids
    and the step's last-position logits."""
    steps, decode = [], jeng._decode

    def recorded(params, tokens, caches, pos):
        logits, caches = decode(params, tokens, caches, pos)
        steps.append(([s.rid for s in jeng.slots], np.asarray(logits[:, -1, : jeng.cfg.vocab_size])))
        return logits, caches

    jeng._decode = recorded
    return steps


def _batch_margin_at(steps, rid, j, tok):
    """The reference engine's own margin for `tok` as rid's j-th token
    (j >= 1: the (j-1)-th decode step that held rid)."""
    held = [(rids.index(rid), logits) for rids, logits in steps if rid in rids]
    row, logits = held[j - 1]
    return float(logits[row].max() - logits[row, tok])


@pytest.mark.parametrize("variant", ["h2o-danube-1.8b", "h2o-danube-1.8b+gqa", "gemma-7b",
                                     "qwen2-moe-a2.7b", "qwen2-moe-a2.7b+cap",
                                     "deepseek-v2-lite-16b", "deepseek-v2-lite-16b+cap",
                                     "jamba-1.5-large-398b", "xlstm-125m",
                                     "llava-next-mistral-7b"])
def test_engine_matches_reference_engine(variant):
    jcfg, cfg = _cfg(variant, jax_side=True), _cfg(variant)
    jm = jax_build_model(jcfg)
    jp = with_qkv_biases(jcfg, jm.init(jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    reqs = _requests(cfg, SCHEDULE[:4])
    capacity = 40
    ours = Engine(cfg, params, num_slots=2, capacity=capacity, device="cpu").run(list(reqs))
    jreqs = [JaxRequest(r.rid, jnp.asarray(r.prompt.numpy(), jnp.int32), r.max_new) for r in reqs]
    jeng = JaxEngine(jcfg, jp, num_slots=2, capacity=capacity)
    coupled = variant.endswith("+cap")
    steps = _record_decode(jeng)
    ref = jeng.run(jreqs)
    for r in reqs:
        a, b = ours[r.rid], ref[r.rid]
        assert len(a) == len(b) == r.max_new
        if a != b:  # a cross-framework near-tie flipped: check that it is one
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            if coupled and j > 0:
                margin = _batch_margin_at(steps, r.rid, j, a[j])
            else:
                margin = _jax_margin_at(jm, jp, jcfg, r.prompt.numpy(), a[:j], a[j], capacity)
            assert margin <= MARGIN, (r.rid, j, margin)


def test_capacity_couples_decode_rows():
    """At capacity factor 1.25 a 2-row decode step gives each expert one
    slot, so in both packages a row's logits depend on the other row (the
    earlier row wins a shared expert): changing row 0's token moves row 1."""
    jcfg, cfg = _cfg("qwen2-moe-a2.7b+cap", jax_side=True), _cfg("qwen2-moe-a2.7b+cap")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    m = build_model(cfg, device="cpu")
    toks = _tokens_np(cfg, 2, 12)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    jc = jax_transformer.pad_caches(jcfg, jc, 16)
    pos = np.array([12, 12], np.int32)
    moved = []
    for first in range(cfg.vocab_size):
        step = np.array([[first], [7]], np.int32)
        jl, _ = jm.decode_step(jp, jnp.asarray(step), jc, jnp.asarray(pos))
        tc = lm_caches_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
        tl, _ = m.decode_step(params, torch.from_numpy(step), tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        moved.append(np.asarray(jl[1]))
        if first and not np.array_equal(moved[0], moved[-1]):
            break
    assert not np.array_equal(moved[0], moved[-1]), "row 1 never depended on row 0"


def test_engine_needs_two_slots():
    cfg = reduce_config(get_config("h2o-danube-1.8b"))
    with pytest.raises(ValueError, match="num_slots"):
        Engine(cfg, {}, num_slots=1, capacity=8, device="cpu")


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    cfg = reduce_config(get_config("h2o-danube-1.8b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, {}, num_slots=2, capacity=8)


def test_splice_cache_copies_in_place():
    """The prompt's rows land in rows [0, L) of the slot, in place; rows past
    L and the other slots keep what they held."""
    dst = {"stack": [{"self": {"k": torch.full((1, 3, 8, 2, 4), -1.0)}}]}
    src = {"stack": [{"self": {"k": torch.ones(1, 1, 5, 2, 4)}}]}
    k = dst["stack"][0]["self"]["k"]
    _splice_cache(dst, src, 2)
    assert dst["stack"][0]["self"]["k"] is k
    assert k[:, 2, :5].eq(1).all() and k[:, 2, 5:].eq(-1).all() and k[:, :2].eq(-1).all()
    for bad in ((1, 1, 9, 2, 4), (1, 1, 5, 1, 4), (1, 2, 5, 2, 4)):  # too long, kvh, batch
        with pytest.raises(ValueError, match="splice"):
            _splice_cache(dst, {"stack": [{"self": {"k": torch.ones(bad)}}]}, 0)


@pytest.mark.parametrize("layout", ["prefix", "stack"])
def test_admit_writes_prompt_rows_only(layout):
    """_admit splices the prefill cache's L rows straight into the slot: the
    slot's rows past L keep a previous request's stale values, and decoding
    over them matches decoding over a zero-padded cache (the kv_len mask)."""
    cfg = _cfg("h2o-danube-1.8b+gqa")
    if layout == "prefix":  # the same layers as prefix layers (no period stack)
        cfg = dataclasses.replace(cfg, prefix=cfg.period * cfg.num_periods, period=(),
                                  num_layers=len(cfg.period) * cfg.num_periods)
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, num_slots=2, capacity=40, device="cpu")
    transformer.tree_map(lambda t: t.fill_(7.0), eng.caches)  # stale rows
    req = _requests(cfg, [(21, 3)])[0]
    eng._admit(req, 1)
    b_axis = 0 if layout == "prefix" else 1
    leaves = []
    transformer.tree_map(leaves.append, eng.caches[layout])
    assert leaves
    for t in leaves:
        slot = t.narrow(b_axis, 1, 1)
        assert slot.narrow(b_axis + 1, 21, 19).eq(7.0).all()
        assert not slot.narrow(b_axis + 1, 0, 21).eq(7.0).any()
        assert t.narrow(b_axis, 0, 1).eq(7.0).all()
    results = eng.run([])
    assert results[req.rid] == eng.results[req.rid]
    assert max(_margins(m, params, cfg, req, results[req.rid], 40)) <= MARGIN


def test_launcher_serves_reduced_on_cpu(capsys):
    launch_serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--requests", "3",
                       "--slots", "2", "--gen", "4", "--prompt-len", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out


def test_launcher_serves_reduced_moe_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--requests", "3",
                       "--slots", "2", "--gen", "4", "--prompt-len", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out


def test_launcher_trains_reduced_moe_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "done: final loss" in capsys.readouterr().out
    assert (tmp_path / "step_00000002").is_dir()


def test_launcher_serves_reduced_mla_on_cpu(capsys):
    launch_serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--requests", "3",
                       "--slots", "2", "--gen", "4", "--prompt-len", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out


def test_launcher_trains_reduced_mla_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"])
    assert "done: final loss" in capsys.readouterr().out
    assert (tmp_path / "step_00000002").is_dir()


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_launcher_serves_and_trains_reduced_recurrent_on_cpu(arch, tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    launch_serve.main(["--arch", arch, "--reduced", "--requests", "3", "--slots", "2",
                       "--gen", "4", "--prompt-len", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out
    launch_train.main(["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "done: final loss" in capsys.readouterr().out
    assert (tmp_path / "step_00000002").is_dir()


def test_launcher_serves_and_trains_reduced_llava_on_cpu(tmp_path, capsys):
    """The embedding-input arch through both launchers on token batches."""
    from repro_torch.launch import train as launch_train

    arch = "llava-next-mistral-7b"
    launch_serve.main(["--arch", arch, "--reduced", "--requests", "3", "--slots", "2",
                       "--gen", "4", "--prompt-len", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out
    launch_train.main(["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "done: final loss" in capsys.readouterr().out
    assert (tmp_path / "step_00000002").is_dir()


def test_launcher_reservoir_mode_is_refused():
    # reservoir mode and its fleet tier are served (tests/test_torch_launch.py);
    # what the launcher refuses, as the reference's does, is --fleet in LM mode
    with pytest.raises(SystemExit):
        launch_serve.main(["--fleet", "--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu"])
