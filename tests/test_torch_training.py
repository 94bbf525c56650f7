"""The port's LM training against ``repro.training`` and ``repro.models``
on the CPU: ``chunked_ce`` and ``lm_loss`` (reduced gemma-2b) and
``encdec_loss`` (reduced whisper-small), value and gradient against
``jax.value_and_grad``; AdamW-Q8 over three steps; the gradient
compressor's error feedback; checkpoints (round trip and pruning, a
template mismatch, trees written by either package restored by the
other); the train loop's loss history against the reference's on the
same token stream and initial weights, kill and resume, the watchdog; the
training entry point and the example; and the flash kernel's
``autograd.Function`` run with the plain forward. The same Function with
the kernel's forward is a ``gpu`` test in ``tests/test_torch_kernels.py``
(the card's machine has no JAX to import this file).

Tolerances: forward values 1e-5 of the reference's largest magnitude,
losses 1e-5 relative, gradients 1e-4 of each leaf's largest magnitude (f32
sums in other orders; the bf16 operands of the loss head are rounded the
same way in both)."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.nn import layers as jlayers
from repro.nn import transformer as jtrans
from repro.runtime import Runtime as JRuntime
from repro import training as jtr
from repro_torch import training as ttr
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.data.tokens import TokenStream
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import (FUNCTION_CALLS,
                                                 flash_attention_autograd)
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.nn import layers as tlayers
from repro_torch.nn import transformer as ttrans
from repro_torch.nn.layers import tree_leaves, tree_map
from repro_torch.runtime import Runtime

CPU = Runtime(device="cpu", q_chunk=16)
JRT = JRuntime(impl="ref", q_chunk=16)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU tests run small shapes, where torch's intra-op
    threads mostly spin: one thread for this file's tests (the suite's
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    yield
    jax.clear_caches()


def _gemma():
    j = reduced(get_config("gemma-2b"), n_layers=2)
    t = treduced(tget_config("gemma-2b"), n_layers=2)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _whisper():
    kw = dict(n_enc_layers=2)
    j = dataclasses.replace(reduced(get_config("whisper-small"),
                                    n_layers=2), **kw)
    t = dataclasses.replace(treduced(tget_config("whisper-small"),
                                     n_layers=2), **kw)
    return j, t


def _batch(cfg, b=2, s=24, seed=0, frames=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if frames:
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _flat_jax(tree):
    """{path: array} of a JAX pytree, paths as the checkpoint names
    them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


def _flat_torch(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_torch(v, prefix + (i,)))
        return out
    return {"/".join(map(str, prefix)): tree.detach().numpy()}


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(1.0, e - 8)


def _grads_close(got, want, bf16_leaves=()):
    """Each leaf within GRAD_RTOL of its largest magnitude. A leaf in
    ``bf16_leaves`` is the gradient of a bf16 operand (the loss head's
    weight in ``chunked_ce``): both packages round their f32 sums to bf16,
    and where the two sums straddle a rounding boundary they land a bf16
    step apart, so each element may also differ by one bf16 step of its
    own magnitude."""
    g, w = _flat_torch(got), _flat_jax(want)
    assert set(g) == set(w)
    for path, ref in w.items():
        tol = GRAD_RTOL * max(np.abs(ref).max(), 1e-30)
        if path in bf16_leaves:
            tol = tol + np.maximum(_bf16_ulp(g[path]), _bf16_ulp(ref))
        diff = np.abs(g[path] - ref)
        assert (diff <= tol).all(), (path, diff.max())


def _loss_close(got, want):
    got, want = float(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got)), float(want)
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


# -- losses and gradients ----------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(24, 8), (20, 8)],
                         ids=["three-chunks", "one-chunk"])
def test_chunked_ce_value_and_grad_match_reference(s, chunk):
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, s, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 96)) * 0.2).astype(np.float32)
    y = rng.integers(0, 96, (2, s)).astype(np.int32)

    def jloss(h, w):
        ce, z = jlm.chunked_ce(h, w, jnp.asarray(y), chunk=chunk)
        return ce + 1e-2 * z
    jv, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.tensor(a, requires_grad=True) for a in (h, w))
    ce, z = tlm.chunked_ce(th, tw, torch.as_tensor(y), chunk=chunk)
    tv = ce + 1e-2 * z
    tgh, tgw = torch.autograd.grad(tv, (th, tw))
    _loss_close(tv, jv)
    _grads_close({"h": tgh, "w": tgw}, {"h": jgh, "w": jgw},
                 bf16_leaves=("h", "w"))


def _head_vjp_jax(h, w, labels):
    """The loss head's value and cotangents (of h and of the (D, V) head)
    in the reference."""
    def head(h, w):
        ce, z = jlm.chunked_ce(h, w, labels)
        return ce + jlm.Z_WEIGHT * z
    return jax.value_and_grad(head, argnums=(0, 1))(h, w)


def _head_vjp_torch(h, w, labels):
    th, tw = (torch.tensor(np.asarray(a), requires_grad=True) for a in (h, w))
    ce, z = tlm.chunked_ce(th, tw, torch.tensor(np.asarray(labels)))
    loss = ce + tlm.Z_WEIGHT * z
    return loss.detach(), torch.autograd.grad(loss, (th, tw))


def _backbone_vjp_torch(params, backbone, dh):
    """The port's gradients of every leaf of ``params`` under the cotangent
    ``dh`` of ``backbone(params)`` (zeros for a leaf it does not read)."""
    live = [leaf.detach().requires_grad_(True)
            for leaf in tree_leaves(params)]
    it = iter(live)
    tree = tree_map(lambda _, leaf: next(it), params)
    grads = torch.autograd.grad(backbone(tree), live, dh, allow_unused=True)
    grads = iter(torch.zeros_like(leaf) if g is None else g
                 for g, leaf in zip(grads, live))
    return tree_map(lambda _, leaf: next(grads), params)


def _split_grads_close(jp, jbackbone, tbackbone, head_w, labels):
    """A loss's gradient held in the two parts where the packages may
    part, as ``test_train_step_matches_reference_from_the_same_state``
    holds a step: the loss head's value within LOSS_RTOL and its
    cotangents (of h and of the head ``head_w(params)``) each element
    within GRAD_RTOL of the largest plus one bf16 step (both packages
    round these f32 sums to bf16, ``chunked_ce``'s bf16 operands); then
    the backbone's gradients (``jbackbone``/``tbackbone``: params -> the
    final-normed h) under the reference's cotangent of h, within GRAD_RTOL
    of each leaf's largest with no bf16 step. A whole gradient cannot be
    held to GRAD_RTOL: a flipped element of h's cotangent reaches every
    backbone leaf."""
    h, backbone_vjp = jax.vjp(jbackbone, jp)
    w = head_w(jp)
    jhv, (jdh, jdw) = _head_vjp_jax(h, w, labels)
    thv, (tdh, tdw) = _head_vjp_torch(h, w, labels)
    _loss_close(thv, jhv)
    _grads_close({"h": tdh, "w": tdw}, {"h": jdh, "w": jdw},
                 bf16_leaves=("h", "w"))
    _grads_close(_backbone_vjp_torch(params_from_reference(jp), tbackbone,
                                     torch.tensor(np.asarray(jdh))),
                 backbone_vjp(jdh)[0])


def test_lm_loss_value_and_grad_match_reference():
    """The loss and its parts within LOSS_RTOL; the gradient in the two
    parts of ``_split_grads_close``."""
    jcfg, tcfg = _gemma()
    jp = jlm.lm_init(jax.random.PRNGKey(1), jcfg)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (jv, jm), jg = jax.value_and_grad(jlm.lm_loss, has_aux=True)(
        jp, jb, jcfg, JRT)
    (tv, tm), tg = ttr.value_and_grad(
        tlm.lm_loss, params_from_reference(jp), tb, tcfg, CPU, has_aux=True)
    _loss_close(tv, jv)
    _loss_close(tm["ce"], jm["ce"])
    assert set(_flat_torch(tg)) == set(_flat_jax(jg))
    jpos = jlm._default_positions(jcfg, *jb["tokens"].shape)
    tpos = tlm._default_positions(tcfg, *tb["tokens"].shape, "cpu")
    _split_grads_close(
        jp, lambda p: jlm._backbone(p, jcfg, jb["tokens"], jpos, JRT)[0],
        lambda p: tlm._backbone(p, tcfg, tb["tokens"], tpos, CPU)[0],
        lambda p: jlm._head_w(p, jcfg), jb["labels"])


def _jax_encdec_backbone(cfg, batch):
    """params -> whisper's final-normed decoder output h, as the
    reference's ``encdec_loss`` computes it."""
    tokens = batch["tokens"]
    pos = jlm._default_positions(cfg, *tokens.shape)

    def run(p):
        enc_out = jed.encdec_encode(p, batch["frames"], cfg, JRT)
        x = jlayers.embedding_apply(p["embed"], tokens)
        h, _ = jtrans.stack_apply(p["dec_stack"], x, pos, jed.dec_cfg(cfg),
                                  JRT, enc_out=enc_out)
        return jlayers.norm_apply(cfg.norm, p["final_norm"], h)
    return run


def _torch_encdec_backbone(cfg, batch):
    """The port's twin of ``_jax_encdec_backbone``."""
    tokens = batch["tokens"]
    pos = tlm._default_positions(cfg, *tokens.shape, tokens.device)

    def run(p):
        enc_out = ted.encdec_encode(p, batch["frames"], cfg, CPU)
        x = tlayers.embedding_apply(p["embed"], tokens)
        h, _ = ttrans.stack_apply(p["dec_stack"], x, pos, ted.dec_cfg(cfg),
                                  CPU, enc_out=enc_out)
        return tlayers.norm_apply(cfg.norm, p["final_norm"], h)
    return run


def test_encdec_loss_value_and_grad_match_reference():
    """whisper-small: the loss within LOSS_RTOL; the gradient in the two
    parts of ``_split_grads_close`` (the untied head is the head
    operand)."""
    jcfg, tcfg = _whisper()
    jp = jed.encdec_init(jax.random.PRNGKey(2), jcfg)
    batch = _batch(jcfg, s=12, frames=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (jv, _), jg = jax.value_and_grad(jed.encdec_loss, has_aux=True)(
        jp, jb, jcfg, JRT)
    (tv, _), tg = ttr.value_and_grad(
        ted.encdec_loss, params_from_reference(jp), tb, tcfg, CPU,
        has_aux=True)
    _loss_close(tv, jv)
    assert set(_flat_torch(tg)) == set(_flat_jax(jg))
    _split_grads_close(
        jp, _jax_encdec_backbone(jcfg, jb), _torch_encdec_backbone(tcfg, tb),
        lambda p: p["head"]["w"], jb["labels"])


@pytest.mark.parametrize("causal,sq,skv,rep", [
    (True, 24, 24, 2), (False, 24, 24, 1), (False, 5, 40, 1)],
    ids=["causal-gqa", "encoder", "cross"])
def test_flash_function_with_plain_forward_matches_autograd(causal, sq, skv,
                                                            rep):
    """The Function's forward injected with the plain version (the CPU has
    no kernel): its output and its gradients equal plain autograd through
    the same plain version; the backward ran once per forward."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 2 * rep, sq, 16)).astype(np.float32)
    k, v, g = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 2, skv, 16), (2, 2, skv, 16), q.shape))

    def plain(q, k, v, *, causal):
        return kref.flash_attention_ref(q, k, v, causal=causal, q_chunk=8)

    def run(fn):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = fn(*ts)
        return out.detach(), torch.autograd.grad(out, ts,
                                                 torch.as_tensor(g))
    FUNCTION_CALLS.clear()
    got, got_g = run(lambda *t: flash_attention_autograd(
        *t, causal=causal, q_chunk=8, forward=plain))
    want, want_g = run(lambda *t: plain(*t, causal=causal))
    assert FUNCTION_CALLS == {"forward": 1, "backward": 1}
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert (a - b).abs().max() <= GRAD_RTOL * b.abs().max()


# -- the optimizer and the compressor ----------------------------------------

def test_adamw_q8_matches_reference_over_three_steps():
    """The same params and gradients through both AdamW-Q8s: params and
    dequantized moments agree (two f32 sums in another order may land on
    either side of a codebook midpoint, so codes are not compared raw), and
    the moments stay uint8 codes with one f32 scale per channel; the
    stacked (3, 64, 96) leaf is large enough only at full width to take
    the per-slice update, so it is also run with the slice threshold
    lowered."""
    from repro_torch.training import optimizer as topt
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((64, 96)).astype(np.float32),
              "stack": {"k": rng.standard_normal((3, 64, 96))
                        .astype(np.float32)},
              "b": rng.standard_normal(96).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda v: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32),
        params) for _ in range(3)]
    jopt = jtr.make_optimizer("adamw_q8", lr=1e-2, weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    for g in grads:
        jp, js = jopt.update(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
    for threshold in (topt._SLICE_ABOVE, 0):
        topt._SLICE_ABOVE, saved = threshold, topt._SLICE_ABOVE
        try:
            opt = ttr.make_optimizer("adamw_q8", lr=1e-2, weight_decay=0.01)
            tp = params_from_reference(params)
            ts = opt.init(tp)
            for g in grads:
                tp, ts = opt.update(tp, params_from_reference(g), ts)
        finally:
            topt._SLICE_ABOVE = saved
        assert ts["step"] == int(js["step"]) == 3
        assert ts["mu"]["w"]["codes"].dtype == torch.uint8
        assert tuple(ts["nu"]["stack"]["k"]["scale"].shape) == (3, 64, 1)
        for path, want in _flat_jax(jp).items():
            got = _flat_torch(tp)[path]
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        for name, levels in (("mu", "sp2_8"), ("nu", None)):
            got, want = ts[name], js[name]
            lut = (np.asarray(jtr.optimizer.spx.codebook(
                jtr.optimizer.spx.scheme_levels(levels)))
                if levels else None)
            for key in ("w", "b"):
                g_codes = got[key]["codes"].numpy()
                w_codes = np.asarray(want[key]["codes"])
                flips = np.mean(g_codes != w_codes)
                assert flips <= 1e-3, (name, key, flips)
                np.testing.assert_allclose(got[key]["scale"].numpy(),
                                           np.asarray(want[key]["scale"]),
                                           rtol=1e-5)
                if lut is not None:
                    same = g_codes == w_codes
                    np.testing.assert_array_equal(
                        lut[g_codes][same], lut[w_codes][same])


def test_grad_compressor_error_feedback():
    """As the reference's compressor over three steps (compressed grads
    and residuals), and, as tests/test_training.py, the time average of
    the compressed gradients tracks the true gradient far better than
    one-shot quantization."""
    rng = np.random.default_rng(0)
    g_true = (rng.standard_normal((4, 4096)) * 1e-3).astype(np.float32)
    small = rng.standard_normal(8).astype(np.float32)
    jcomp = jtr.GradCompressor("sp2_8")
    tcomp = ttr.GradCompressor("sp2_8")
    jg = {"g": jnp.asarray(g_true), "small": jnp.asarray(small)}
    tg = {"g": torch.as_tensor(g_true), "small": torch.as_tensor(small)}
    jef, tef = jcomp.init(jg), tcomp.init(tg)
    assert tuple(tef["small"].shape) == ()
    for _ in range(3):
        jq, jef = jcomp.compress(jg, jef)
        tq, tef = tcomp.compress(tg, tef)
        assert torch.equal(tq["small"], tg["small"])
        np.testing.assert_allclose(tq["g"].numpy(), np.asarray(jq["g"]),
                                   atol=1e-9)
        np.testing.assert_allclose(tef["g"].numpy(), np.asarray(jef["g"]),
                                   atol=1e-9)
    comp = ttr.GradCompressor("sp2_4", min_size=1)
    g = {"g": torch.as_tensor(g_true)}
    ef = comp.init(g)
    acc = torch.zeros_like(g["g"])
    n = 24
    for _ in range(n):
        gq, ef = comp.compress(g, ef)
        acc += gq["g"]
    avg_err = float(torch.linalg.norm(acc / n - g["g"])
                    / torch.linalg.norm(g["g"]))
    gq1, _ = comp.compress(g, comp.init(g))
    one_shot = float(torch.linalg.norm(gq1["g"] - g["g"])
                     / torch.linalg.norm(g["g"]))
    assert avg_err < one_shot * 0.5, (avg_err, one_shot)
    assert comp.wire_bits() == 4


# -- checkpoints -------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4), {"c": torch.full((2, 2), 1.5,
                                                  dtype=torch.bfloat16)}],
            "step": 7}


def test_checkpoint_roundtrip_and_prune(tmp_path):
    tree = _tree()
    for step in (10, 20, 30, 40):
        ttr.save_checkpoint(str(tmp_path), step, tree, keep=2)
    assert ttr.latest_step(str(tmp_path)) == 40
    assert ttr.list_checkpoints(str(tmp_path)) == [30, 40]
    restored, step, _ = ttr.restore_checkpoint(str(tmp_path), tree)
    assert step == 40
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"][1]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"][1]["c"], tree["b"][1]["c"])
    assert restored["step"] == 7 and isinstance(restored["step"], int)
    files = sorted(p.name for p in (tmp_path / "step_40").iterdir())
    assert files == ["_COMMITTED", "leaf_0.npy", "leaf_1.npy", "leaf_2.npy",
                     "leaf_3.npy", "manifest.json"]


def test_checkpoint_template_mismatch_raises(tmp_path):
    ttr.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="mismatch"):
        ttr.restore_checkpoint(str(tmp_path), {"zz": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ttr.restore_checkpoint(str(tmp_path), {"a": torch.zeros(4)})


def test_checkpoints_cross_between_packages(tmp_path):
    """A params tree (and an optimizer state) written by ``repro`` restores
    in the port, and the port's restores in ``repro``: same paths, files
    and manifest."""
    jcfg, _ = _gemma()
    jp = jlm.lm_init(jax.random.PRNGKey(4), jcfg)
    js = jtr.make_optimizer("adamw", lr=1e-3).init(jp)
    jtr.save_checkpoint(str(tmp_path / "jax"), 3, (jp, js))
    tmpl = (params_from_reference(jax.tree_util.tree_map(jnp.zeros_like,
                                                         jp)),
            ttr.make_optimizer("adamw", lr=1e-3).init(
                params_from_reference(jp)))
    (tp, ts), step, _ = ttr.restore_checkpoint(str(tmp_path / "jax"), tmpl)
    assert step == 3 and ts["step"] == 0
    for path, want in _flat_jax(jp).items():
        np.testing.assert_array_equal(_flat_torch(tp)[path], want)
    tp["embed"]["table"] += 1.0
    ttr.save_checkpoint(str(tmp_path / "torch"), 5, (tp, ts))
    (rp, rs), step, _ = jtr.restore_checkpoint(str(tmp_path / "torch"),
                                               (jp, js))
    assert step == 5 and int(rs["step"]) == 0
    for path, want in _flat_torch(tp).items():
        np.testing.assert_array_equal(_flat_jax(rp)[path], want)


# -- the train loop ----------------------------------------------------------

def _loop_pair(tmp_path, steps, opt=("adamw", dict(lr=3e-3)), **tc):
    """(reference loop, port loop, closers) on reduced gemma-2b, the same
    initial weights and token streams of seed 0, the optimizer ``opt``
    (name, kwargs), and ``tc`` in both loops' TrainConfig."""
    jcfg, tcfg = _gemma()
    jp = jlm.lm_init(jax.random.PRNGKey(5), jcfg)
    tp = params_from_reference(jp)      # before the reference donates jp
    jdata = JTokenStream(jcfg.vocab_size, 2, 16, seed=0)
    tdata = TokenStream(tcfg.vocab_size, 2, 16, seed=0)
    jloop = jtr.TrainLoop(
        lambda p, b: jlm.lm_loss(p, b, jcfg, JRT),
        jtr.make_optimizer(opt[0], **opt[1]), lambda: jp, iter(jdata),
        jtr.TrainConfig(max_steps=steps, log_every=100, **tc))
    tloop = ttr.TrainLoop(
        lambda p, b: tlm.lm_loss(p, b, tcfg, CPU),
        ttr.make_optimizer(opt[0], **opt[1]),
        lambda: tp, iter(tdata),
        ttr.TrainConfig(max_steps=steps, log_every=100, **tc))
    return jloop, tloop, (jdata.close, tdata.close)


#: the loss history after the first update: 1e-4 relative (see below)
HISTORY_RTOL = 1e-4


@pytest.mark.parametrize("opt", [("sgd", dict(lr=0.5, momentum=0.9)),
                                 ("adamw", dict(lr=3e-3))],
                         ids=["sgd", "adamw"])
def test_train_loop_history_matches_reference(tmp_path, opt):
    """Five steps on the same batches (the token streams agree for a seed)
    from the same initial weights. The first step's loss, before any
    update, within 1e-5 relative of the reference's; the later ones within
    HISTORY_RTOL. The loss head takes bf16 operands in both packages, so
    the gradients of h and of the tied table are f32 sums rounded to bf16,
    and the two packages' sums, taken in other orders, land one bf16 step
    (2^-8 relative) apart on about 0.2% of the elements; each update
    carries that into the weights. Measured over these five steps: up to
    3.3e-5 (SGD) and 1.5e-5 (AdamW). That these roundings are the only
    difference between the packages' steps is held step by step in
    ``test_train_step_matches_reference_from_the_same_state``."""
    jloop, tloop, closers = _loop_pair(tmp_path, 5, opt)
    try:
        _, jh = jloop.run()
        _, th = tloop.run()
    finally:
        for close in closers:
            close()
    assert [r["step"] for r in th] == [1, 2, 3, 4, 5]
    _loss_close(th[0]["loss"], jh[0]["loss"])
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= HISTORY_RTOL * abs(b["loss"]), \
            (a, b)


#: the port's update of the reference's own gradients, against the
#: reference's update: within this of each leaf's largest update, plus
#: one f32 step of the updated parameter (``p - lr * u`` rounds there)
UPDATE_RTOL = 1e-5


@pytest.mark.parametrize("opt", [("sgd", dict(lr=0.5, momentum=0.9)),
                                 ("adamw", dict(lr=3e-3))],
                         ids=["sgd", "adamw"])
def test_train_step_matches_reference_from_the_same_state(opt):
    """Each of the history test's five steps, taken by both packages from
    the reference's params and optimizer state at that step on the same
    batch, split where the packages may part:

    * the loss within LOSS_RTOL;
    * the loss head's cotangents, of h and of the (tied) head, each
      element within GRAD_RTOL of the largest plus one bf16 step: both
      packages round these f32 sums to bf16 (``chunked_ce``'s bf16
      operands), and about 0.2% of them land a step apart;
    * the backbone's gradients under the reference's cotangent of h within
      GRAD_RTOL of each leaf's largest, with no bf16 step;
    * the port's clipping and update of the reference's gradients within
      UPDATE_RTOL of each leaf's largest update (plus one f32 step of the
      parameter).

    So the packages' steps differ only by the bf16 roundings of the head's
    cotangents, and the drift HISTORY_RTOL allows comes from those alone.
    (Whole steps cannot be held to GRAD_RTOL: a flipped element of h's
    cotangent reaches every backbone leaf, measured up to 1e-3 of a leaf's
    largest update at step 1, and AdamW's first update, m / sqrt(v), turns
    an f32-rounding difference of a near-zero gradient into a step of
    either sign.)"""
    jcfg, tcfg = _gemma()
    name, kw = opt
    jopt, topt = (pkg.make_optimizer(name, **kw) for pkg in (jtr, ttr))
    jp = jlm.lm_init(jax.random.PRNGKey(5), jcfg)
    js = jopt.init(jp)
    jstep = jax.jit(jtr.make_grad_accum_step(
        lambda p, b: jlm.lm_loss(p, b, jcfg, JRT), jopt))
    data = JTokenStream(jcfg.vocab_size, 2, 16, seed=0)
    try:
        for _ in range(5):
            batch = next(data)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            tb = {k: torch.as_tensor(v) for k, v in batch.items()}
            tp = params_from_reference(jp)
            ts = {k: int(v) if k == "step" else params_from_reference(v)
                  for k, v in js.items()}
            (jv, _), jg = jax.value_and_grad(jlm.lm_loss, has_aux=True)(
                jp, jb, jcfg, JRT)
            (tv, _), _ = ttr.value_and_grad(tlm.lm_loss, tp, tb, tcfg, CPU,
                                            has_aux=True)
            _loss_close(tv, jv)

            jpos = jlm._default_positions(jcfg, *jb["tokens"].shape)
            tpos = tlm._default_positions(tcfg, *tb["tokens"].shape, "cpu")
            _split_grads_close(
                jp,
                lambda p: jlm._backbone(p, jcfg, jb["tokens"], jpos, JRT)[0],
                lambda p: tlm._backbone(p, tcfg, tb["tokens"], tpos, CPU)[0],
                lambda p: jlm._head_w(p, jcfg), jb["labels"])

            jclip, _ = jtr.clip_by_global_norm(jg, 1.0)
            want, _ = jopt.update(jp, jclip, js)
            tclip, _ = ttr.clip_by_global_norm(params_from_reference(jg),
                                               1.0)
            got, _ = topt.update(tp, tclip, ts)
            old, new, got = _flat_jax(jp), _flat_jax(want), _flat_torch(got)
            for path in new:
                tol = (UPDATE_RTOL * np.abs(new[path] - old[path]).max()
                       + np.spacing(np.abs(new[path])))
                assert (np.abs(got[path] - new[path]) <= tol).all(), path

            jp, js, _, _ = jstep(jp, js, jnp.zeros(()), jb)
    finally:
        data.close()


def test_token_stream_matches_reference():
    a, b = TokenStream(64, 3, 8, seed=9), JTokenStream(64, 3, 8, seed=9)
    try:
        for _ in range(3):
            x, y = next(a), next(b)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(x[k], y[k])
    finally:
        a.close()
        b.close()
    assert not a._thread.is_alive()


def test_kill_and_resume_reproduces_unbroken_run(tmp_path):
    """Killed at step 3 after a checkpoint at step 2, then resumed: the
    resumed run replays the stream to the batch the unbroken run took, so
    steps 3 to 5 give the unbroken run's losses (within 1e-5 relative: the
    restored tensors are new allocations, and the CPU's BLAS may sum in
    another order by their alignment)."""
    _, unbroken, closers = _loop_pair(tmp_path, 5)
    try:
        _, want = unbroken.run()
    finally:
        for close in closers:
            close()
    ckpt = str(tmp_path / "ckpt")
    _, killed, closers = _loop_pair(tmp_path, 5, ckpt_dir=ckpt,
                                    ckpt_every=2, kill_at_step=3)
    try:
        with pytest.raises(KeyboardInterrupt):
            killed.run()
    finally:
        for close in closers:
            close()
    assert ttr.latest_step(ckpt) == 2
    _, resumed, closers = _loop_pair(tmp_path, 5, ckpt_dir=ckpt,
                                     ckpt_every=2)
    try:
        _, got = resumed.run()
    finally:
        for close in closers:
            close()
    assert [r["step"] for r in got] == [3, 4, 5]
    for a, b in zip(got, want[2:]):
        _loss_close(a["loss"], b["loss"])
    assert ttr.latest_step(ckpt) == 5


def test_resume_departs_from_the_reference_by_replaying_the_stream(
        tmp_path):
    """A deliberate departure from the reference: a resumed port loop
    first draws the batches the restored steps took, so it goes on where an
    unbroken run would; the reference's resumed loop restarts its stream
    (repro/training/train_loop.py) and trains again on the first batches.
    From a checkpoint the reference wrote at step 2, the port's step-3 loss
    is the reference's on a stream advanced by two batches (within
    LOSS_RTOL), and not the reference's own resumed loss."""
    ckpt = str(tmp_path / "ckpt")
    jloop, _, closers = _loop_pair(tmp_path, 2, ckpt_dir=ckpt)
    try:
        jloop.run()
    finally:
        for close in closers:
            close()
    assert ttr.latest_step(ckpt) == 2
    losses = {}
    for name, skip in (("reference", 0), ("reference advanced", 2),
                       ("port", 0)):
        jloop, tloop, closers = _loop_pair(tmp_path, 3, ckpt_dir=ckpt)
        try:
            if name == "port":
                _, hist = tloop.run()
            else:
                for _ in range(skip):
                    next(jloop.data)
                _, hist = jloop.run()
        finally:
            for close in closers:
                close()
        assert [r["step"] for r in hist] == [3]
        losses[name] = hist[0]["loss"]
        shutil.rmtree(os.path.join(ckpt, "step_3"))
    _loss_close(losses["port"], losses["reference advanced"])
    assert abs(losses["port"] - losses["reference"]) \
        > 100 * LOSS_RTOL * abs(losses["reference"]), losses


def test_watchdog_flags_straggler():
    wd = ttr.StepWatchdog(stall_factor=3.0, warmup=2, min_stall_s=0.0)
    for _ in range(5):
        wd.observe(0.1)
    with pytest.raises(ttr.StallDetected):
        wd.observe(1.0)
    assert wd.stalls == 1


def test_grad_accumulation_matches_one_batch():
    """Two microbatches of 2 rows: the loss and the update of one batch of
    4 (the mean gradient), to f32 rounding."""
    _, tcfg = _gemma()
    params = tlm.lm_init(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(tcfg, b=4).items()}
    outs = []
    for accum in (1, 2):
        p = jax.tree_util.tree_map(torch.clone, params)
        step = ttr.make_grad_accum_step(
            lambda q, b: tlm.lm_loss(q, b, tcfg, CPU),
            ttr.make_optimizer("sgd", lr=0.1), accum_steps=accum)
        p, _, _, m = step(p, {"step": 0}, torch.zeros(()), batch)
        outs.append((m["loss"], p))
    (l1, p1), (l2, p2) = outs
    assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l1))
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert (a - b).abs().max() <= 1e-5 * max(a.abs().max(), 1e-30)


# -- the entry points --------------------------------------------------------

def test_train_entry_point_reduces_loss(tmp_path):
    from repro_torch.launch import train
    hist = train.main(["--device", "cpu", "--arch", "gemma-2b", "--reduced",
                       "--steps", "20", "--batch", "4", "--seq", "32"])
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first, (first, last)


def test_train_entry_point_encdec_and_resume(tmp_path):
    """whisper-small (reduced) through encdec_loss with zero frames, killed
    at step 2 and resumed from the checkpoint directory."""
    from repro_torch.launch import train
    args = ["--device", "cpu", "--arch", "whisper-small", "--reduced",
            "--steps", "3", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    with pytest.raises(KeyboardInterrupt):
        train.main(args + ["--kill-at-step", "2"])
    assert ttr.latest_step(str(tmp_path)) == 2
    hist = train.main(args)
    assert [h["step"] for h in hist] == [3]
    assert np.isfinite(hist[0]["loss"])


def test_train_llm_tiny_reduces_loss():
    from repro_torch.examples import train_llm
    hist = train_llm.main(["--tiny", "--device", "cpu", "--steps", "20"])
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert len(hist) == 20 and last < first, (first, last)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device works")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "gemma-2b", "--reduced", "--steps", "1"])


# -- the train step under a (data, model) mesh --------------------------------

#: the reference's sharded train cells (tests/test_sharding.py), reduced as
#: it reduces them
MESH_ARCHS = ("granite-3-8b", "olmoe-1b-7b", "jamba-1.5-large-398b",
              "xlstm-350m", "whisper-small", "qwen2-vl-2b")
MESH_B, MESH_S = 8, 32


def _mesh_cfgs(arch):
    j = reduced(get_config(arch), d_model=64, vocab=512)
    t = treduced(tget_config(arch), d_model=64, vocab=512)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(2, 4, ["cpu"] * 8)


def _mesh_inputs(jcfg, b=MESH_B, seed=1):
    """The reference's params (f32, seed 0) and a batch of ``b`` rows."""
    init = jed.encdec_init if jcfg.enc_dec else jlm.lm_init
    jp = init(jax.random.PRNGKey(0), jcfg)
    return jp, _batch(jcfg, b=b, s=MESH_S, seed=seed, frames=jcfg.enc_dec)


def _f32_ce_jax(h, w, labels, **_):
    """``chunked_ce``'s mean cross-entropy and z-loss with f32 operands."""
    logits = jnp.einsum("bsd,dv->bsv", h, w.astype(h.dtype))
    lse = jax.nn.logsumexp(logits, axis=-1)
    true = jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0]
    return jnp.sum(lse - true) / labels.size, jnp.sum(lse * lse) / labels.size


def _f32_ce_torch(h, w, labels, **_):
    logits = torch.einsum("bsd,dv->bsv", h, w.to(h.dtype))
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (torch.sum(lse - true) / labels.numel(),
            torch.sum(lse * lse) / labels.numel())


def _f32_heads(mp):
    """The loss head of both packages' ``lm_loss``/``encdec_loss`` (and
    the mesh's per-device heads) made one f32 cross-entropy.
    ``chunked_ce`` rounds its operands to bf16, and where the packages'
    f32 sums of h straddle a rounding boundary (other orders: the mesh's
    devices, XLA's fusions) the head's cotangents land a bf16 step apart
    and reach every leaf: up to 1.8e-2 of a leaf's update norm here, so a
    step could not be held to GRAD_RTOL. ``chunked_ce`` itself is held to
    the reference with that allowance
    (``test_chunked_ce_value_and_grad_match_reference``)."""
    for mod in (jlm, jed):
        mp.setattr(mod, "chunked_ce", _f32_ce_jax)
    for mod in (tlm, ted):
        mp.setattr(mod, "chunked_ce", _f32_ce_torch)


def _reference_sgd_step(jcfg, jp, batch):
    """The reference's ``build_train_step`` with ``sgd`` on a 1x1 CPU
    mesh (f32, one jitted step from ``jp``; the f32 loss head in place):
    (metrics, the new params by path)."""
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch import steps as jsteps
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    b = jsteps.build_train_step(
        jcfg, JShapeConfig("t", MESH_S, len(batch["tokens"]), "train"), mesh,
        remat="none", optimizer="sgd", dtype=jnp.float32)
    opt = jtr.make_optimizer("sgd", lr=1e-4)
    with mesh:
        new, _, m = jax.jit(b.fn)(
            jp, opt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in m.items()}, _flat_jax(new)


def _mesh_step_matches(b, jcfg, jp, batch, monkeypatch):
    """One SGD step of bundle ``b`` from ``jp`` against
    ``_reference_sgd_step``, both with the f32 loss head: ce, aux, z and
    the loss within LOSS_RTOL, the global norm within GRAD_RTOL, and
    every leaf's update within GRAD_RTOL of the leaf's largest update plus
    the f32 rounding of either parameter (half a step of each)."""
    _f32_heads(monkeypatch)
    jm, new = _reference_sgd_step(jcfg, jp, batch)
    grid, opt = b.place(params_from_reference(jp))
    grid, _, m = b.fn(grid, opt, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    assert set(m) == set(jm)
    for k in ("ce", "aux", "z", "loss"):
        if k in jm:
            assert abs(float(m[k]) - jm[k]) <= LOSS_RTOL * max(abs(jm[k]),
                                                               1e-6), k
    assert abs(float(m["gnorm"]) - jm["gnorm"]) <= GRAD_RTOL * jm["gnorm"]
    got, old = _flat_torch(b.gather(grid)), _flat_jax(jp)
    assert set(got) == set(new)
    for path, w in new.items():
        step = np.abs(w - old[path]).max()
        tol = GRAD_RTOL * step + np.spacing(np.maximum(np.abs(w),
                                                       np.abs(got[path])))
        assert (np.abs(got[path] - w) <= tol).all(), \
            (path, np.abs(got[path] - w).max(), step)


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_train_step_on_mesh_matches_reference(monkeypatch, arch):
    """``build_train_step`` at mesh (2, 4), batch 8 (so ``fsdp``: one row
    per device), f32, against the reference's ``build_train_step`` on a
    1x1 mesh from the same params: ``meta`` carries the reference's keys
    and values; then one step with ``sgd`` (linear in the gradient: each
    leaf's update is its clipped gradient) held to the reference's
    (``_mesh_step_matches``: the metrics, the global norm, every leaf's
    update; the MoE's rows routed together as the reference's)."""
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch import steps as jsteps
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    jcfg, tcfg = _mesh_cfgs(arch)
    jp, batch = _mesh_inputs(jcfg)
    mesh = _host_mesh()
    shape = ShapeConfig("t", MESH_S, MESH_B, "train")
    jmeta = jsteps.build_train_step(
        jcfg, JShapeConfig("t", MESH_S, MESH_B, "train"),
        jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                          ("data", "model")), dtype=jnp.float32).meta
    meta = build_train_step(tcfg, shape, mesh, dtype=torch.float32).meta
    assert {k: meta[k] for k in jmeta} == jmeta
    assert meta["parallelism"] == "fsdp"
    sgd = build_train_step(tcfg, shape, mesh, remat="none", optimizer="sgd",
                           dtype=torch.float32)
    _mesh_step_matches(sgd, jcfg, jp, batch, monkeypatch)


def _gemma_mesh_step(remat="full", b=MESH_B, **kw):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    _, tcfg = _mesh_cfgs("gemma-2b")
    return tcfg, build_train_step(tcfg, ShapeConfig("t", MESH_S, b, "train"),
                                  _host_mesh(), remat=remat,
                                  dtype=torch.float32, **kw)


@pytest.mark.parametrize("b", [8, 4], ids=["fsdp", "tp"])
def test_mesh_step_keeps_copies_identical_and_remat_changes_nothing(b):
    """Two steps of reduced gemma-2b at mesh (2, 4) under ``fsdp`` (batch
    8) and ``tp`` (batch 4: tensor-parallel over model, the batch over
    data): every block held by more than one device (the norms, the K/V
    of the one KV head over the model axis, the table over data) is
    bit-identical on each after both steps, params and moments; and
    ``remat`` none, full and dots give bit-identical params, moments and
    metrics (the checkpointed forward recomputes the same values)."""
    results = {}
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(_mesh_cfgs("gemma-2b")[0], b=b, s=MESH_S).items()}
    for remat in ("none", "full", "dots"):
        tcfg, bundle = _gemma_mesh_step(remat, b=b)
        assert bundle.meta["parallelism"] == ("fsdp" if b == 8 else "tp")
        params = tlm.lm_init(torch.Generator().manual_seed(4), tcfg,
                             device="cpu")
        grid, opt = bundle.place(params)
        for _ in range(2):
            grid, opt, m = bundle.fn(grid, opt, batch)
        results[remat] = (grid, opt, m)
        for trees, specs in ((grid, bundle.specs["params"]),
                             ([[o["mu"] for o in row] for row in opt],
                              {p[1:]: s for p, s in
                               bundle.specs["opt"].items()
                               if p[0] == "mu"})):
            copies = 0
            for path, lay in specs.items():
                axes = {a for e in lay.spec if e is not None
                        for a in (e if isinstance(e, tuple) else (e,))}
                leaves = {}
                for d, row in enumerate(trees):
                    for mm, t in enumerate(row):
                        x = t
                        for k in path:
                            x = x[k]
                        key = (d if "data" in axes else None,
                               mm if "model" in axes else None)
                        leaves.setdefault(key, []).append(x)
                for group in leaves.values():
                    copies += len(group) > 1
                    for x in group[1:]:
                        assert torch.equal(x, group[0]), path
            assert copies > 0
    base = results["none"]
    for remat in ("full", "dots"):
        grid, opt, m = results[remat]
        for a, c in zip(tree_leaves(grid), tree_leaves(base[0])):
            assert torch.equal(a, c), remat
        for a, c in zip(tree_leaves(opt), tree_leaves(base[1])):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, c), remat
        assert {k: float(v) for k, v in m.items()} == \
            {k: float(v) for k, v in base[2].items()}


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-small",
                                  "qwen2-vl-2b"])
def test_tp_step_matches_one_device(monkeypatch, arch):
    """``tp`` (batch 4 at mesh (2, 4): each data group's 2 rows
    tensor-parallel over its 4 model shards) on the patterns it cuts
    otherwise than the dense one: xlstm-350m's recurrent mixers, run once
    from shard 0's copy whole; whisper-small's encoder and cross-attention
    (the head cut on d: its vocabulary does not split); qwen2-vl-2b's
    M-RoPE and q/k/v biases cut with their heads. One ``sgd`` step held
    to the reference's one-device step (``_mesh_step_matches``: the
    metrics, the global norm and every leaf's update)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    jcfg, tcfg = _mesh_cfgs(arch)
    jp, batch = _mesh_inputs(jcfg, b=4)
    b = build_train_step(tcfg, ShapeConfig("t", MESH_S, 4, "train"),
                         _host_mesh(), remat="none", optimizer="sgd",
                         dtype=torch.float32)
    assert b.meta["parallelism"] == "tp"
    _mesh_step_matches(b, jcfg, jp, batch, monkeypatch)


#: the pod axis at its smallest, mesh (pod 2, data 1, model 2): (name,
#: batch, giant). ``fsdp``: 4 rows over (pod, data, model), the weights
#: cut over (data, model) only, a copy in each pod (the cross-pod sum of
#: their gradients: ``reduce_copies``); ``tp``: 2 rows over (pod, data),
#: each pod's row tensor-parallel; ``tp-pod-fsdp``: the same with FSDP
#: over (pod, data), the rule of a model above ``POD_FSDP_ABOVE`` params
#: (that bound and ``FSDP_ABOVE`` patched to 0)
POD_CELLS = [("fsdp", 4, False), ("tp", 2, False), ("tp-pod-fsdp", 2, True)]


@pytest.mark.parametrize("name,b,giant", POD_CELLS,
                         ids=[c[0] for c in POD_CELLS])
def test_pod_mesh_step_matches_reference(monkeypatch, name, b, giant):
    """``build_train_step`` of reduced gemma-2b on a (pod, data, model)
    mesh: one ``sgd`` step held to the reference's one-device step
    (``_mesh_step_matches``: the metrics, the global norm, every leaf's
    update), so a cross-pod gradient dropped, doubled or wrongly weighted
    fails; the layouts put ``pod`` where the reference's rules do."""
    from repro_torch import sharding as tsh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    if giant:
        monkeypatch.setattr(tsh, "FSDP_ABOVE", 0)
        monkeypatch.setattr(tsh, "POD_FSDP_ABOVE", 0)
    jcfg, tcfg = _mesh_cfgs("gemma-2b")
    jp, batch = _mesh_inputs(jcfg, b=b)
    mesh = make_host_mesh(1, 2, ["cpu"] * 4, pod=2)
    bundle = build_train_step(tcfg, ShapeConfig("t", MESH_S, b, "train"),
                              mesh, remat="none", optimizer="sgd",
                              dtype=torch.float32)
    assert bundle.meta["parallelism"] == name.split("-")[0]
    assert bundle.meta["fsdp"] is (name != "tp")
    pod_cut = {path for path, lay in bundle.specs["params"].items()
               if any(e is not None and "pod" in
                      (e if isinstance(e, tuple) else (e,))
                      for e in lay.spec)}
    assert bool(pod_cut) is giant
    _mesh_step_matches(bundle, jcfg, jp, batch, monkeypatch)
