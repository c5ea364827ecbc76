"""The port's research int8 forward (tpu_unet_torch/infer/quant_research.py,
``ResearchQuantInference``) against the JAX package's on the CPU, given the
same QuantParams and input: base width 8, MIN_CHANNELS 16, batch 2 of 188²
(the fixture of tests/test_torch_quant.py). There enc0 stays float and
dec0_conv1 is int8, so the fused int8 skip capture and the paired int8 dec0
tail both run. The kernels' wrappers run their plain versions here."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.infer.quant_research import ResearchQuantInference as JaxResearch
from tpu_unet_torch.infer import quant as tq
from tpu_unet_torch.infer import quant_research as tqr
from tests.test_torch_quant import _jnp, _np, nets, qparams  # noqa: F401 (fixtures)

FUSED = {"fused_enc0": True, "fused_concat": True}
PAIR = {"pair_level0": True}
RTOL, ATOL = 1e-4, 1e-5        # the production forward's logits bar


def _with_skip(qp, skip):
    return dataclasses.replace(qp, cfg=dataclasses.replace(qp.cfg, skip_variant=skip))


def _assert_logits_match(got, want):
    """Logits at rtol 1e-4, and class maps equal wherever JAX's top-2 margin
    exceeds that bar."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    top2 = np.sort(want, -1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * (RTOL * np.abs(want).max() + ATOL)
    assert decided.mean() > 0.9
    assert (got.numpy().argmax(-1) == want.argmax(-1))[decided].all()


def _count_calls(monkeypatch):
    """Count the research forward's calls of each kernel wrapper (the
    wrappers count launches only on the card)."""
    calls = {}
    for name in ("enc0_chain", "concat_quantize", "pair_batch_channels",
                 "unpair_batch_channels", "interleave_pairs"):
        fn = getattr(tqr, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(tqr, name, counted)
    return calls


def test_fused_forward_matches_jax(nets, qparams, monkeypatch):
    """fused_enc0 + fused_concat: K4 (int8 skip at the dec0 concat scale)
    once and K5 at the four quantized decoder concats; the logits as JAX's,
    and the class maps as the production forward's on >= 0.995 of the
    pixels (tests/test_quant.py's bar for the fused forward)."""
    jqp, tqp = qparams
    x = nets["x"]
    want = np.asarray(JaxResearch(jqp, **FUSED).apply(jnp.asarray(x)))
    calls = _count_calls(monkeypatch)
    got = tqr.ResearchQuantInference(tqp, device="cpu", **FUSED).apply(torch.from_numpy(x))
    assert calls == {"enc0_chain": 1, "concat_quantize": 4}
    _assert_logits_match(got, want)
    base = tq.QuantInference(tqp, device="cpu").apply(torch.from_numpy(x))
    assert (got.argmax(-1) == base.argmax(-1)).float().mean() >= 0.995


@pytest.mark.parametrize("skip", ["paper", "parity"])
def test_pair_forward_matches_jax(nets, qparams, monkeypatch, skip):
    """pair_level0 with both skip variants: K6a once (the int8 upconv
    output; the 1-channel input pairs by torch.cat), K6b once (after pool0),
    K6c once (the dec0 concat); the logits and the paired stages as JAX's.
    Pairing adds only structural zeros, so the logits also equal the
    production forward's at the same bar."""
    jqp, tqp = (_with_skip(q, skip) for q in qparams)
    x = nets["x"]
    jqi = JaxResearch(jqp, **PAIR)
    want = np.asarray(jqi.apply(jnp.asarray(x)))
    calls = _count_calls(monkeypatch)
    qi = tqr.ResearchQuantInference(tqp, device="cpu", **PAIR)
    got = qi.apply(torch.from_numpy(x))
    assert calls == {"pair_batch_channels": 1, "unpair_batch_channels": 1,
                     "interleave_pairs": 1}
    _assert_logits_match(got, want)
    base = tq.QuantInference(tqp, device="cpu").apply(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=RTOL, atol=ATOL)
    for stage in ("enc0_conv1", "enc0_conv2", "pool0"):
        t = qi.apply(torch.from_numpy(x), stop_after=stage)
        w = np.asarray(jqi.apply(jnp.asarray(x), stop_after=stage))
        assert t.shape == w.shape, stage       # paired until the unpair after pool0
        np.testing.assert_array_equal(_np(t), _jnp(w), err_msg=stage)


def test_odd_batch_and_flags_off_are_the_production_forward(nets, qparams):
    """An odd batch takes the unpaired path; no research flag is the
    production apply; both bit for bit."""
    tqp = qparams[1]
    x = torch.from_numpy(nets["x"])
    prod = tq.QuantInference(tqp, device="cpu")
    odd = tqr.ResearchQuantInference(tqp, device="cpu", **PAIR).apply(x[:1])
    assert torch.equal(odd, prod.apply(x[:1]))
    off = tqr.ResearchQuantInference(tqp, device="cpu")
    assert torch.equal(off.apply(x), prod.apply(x))
    assert torch.equal(off.apply(x, stop_after="dec1_conv1"),
                       prod.apply(x, stop_after="dec1_conv1"))
    # fused_enc0 needs the full forward and the paper skip: with stop_after
    # or parity skips it runs the production level 0
    fused = tqr.ResearchQuantInference(tqp, device="cpu", fused_enc0=True)
    assert torch.equal(fused.apply(x, stop_after="pool0"), prod.apply(x, stop_after="pool0"))
    parity = _with_skip(tqp, "parity")
    assert torch.equal(
        tqr.ResearchQuantInference(parity, device="cpu", fused_enc0=True).apply(x[:1]),
        tq.QuantInference(parity, device="cpu").apply(x[:1]))


def test_flags_refuse_what_they_do_not_compose_with(nets, qparams):
    """The research flags with phase_level0 or with int4 raise ValueError as
    JAX's class does; phase_level0 alone serves the production phase engine,
    and int4 alone the production int4 forward; enc0_chain's options are
    checked when they reach it."""
    tqp = qparams[1]
    q4 = tq.prepare_quant_params(tqp.cfg, nets["float32"], tqp.scales, tqp.qnames,
                                 q4names=frozenset({"dec1_conv1"}))
    assert q4.q4names == {"dec1_conv1"} and "dec1_conv1" not in q4.qnames
    for flags in (FUSED, PAIR, {"fused_concat": True}):
        with pytest.raises(ValueError, match="phase_level0"):
            tqr.ResearchQuantInference(tqp, phase_level0="int8", device="cpu", **flags)
        with pytest.raises(ValueError, match="int4"):
            tqr.ResearchQuantInference(q4, device="cpu", **flags)
    x = torch.from_numpy(nets["x"])
    # phase_level0 alone is the production phase engine (item 8, ported)
    assert torch.equal(
        tqr.ResearchQuantInference(tqp, phase_level0="bf16", device="cpu").apply(x),
        tq.QuantInference(tqp, phase_level0="bf16", device="cpu").apply(x))
    assert torch.equal(tqr.ResearchQuantInference(q4, device="cpu").apply(x),
                       tq.QuantInference(q4, device="cpu").apply(x))
    # dec0_conv1 is int8 here, so enc0_chain captures an int8 skip, which
    # pool_mode='none' would pool as integers
    for opts, match in (({"pool_mode": "none"}, "quantized skip"),
                        ({"block_rows": 5}, "block_rows")):
        qi = tqr.ResearchQuantInference(tqp, device="cpu", fused_enc0=True,
                                        fused_enc0_opts=opts)
        with pytest.raises(ValueError, match=match):
            qi.apply(x)
    got = tqr.ResearchQuantInference(tqp, device="cpu", fused_enc0=True, fused_enc0_opts={
        "pool_mode": "cols", "block_rows": 16, "block_cols": 128}).apply(x)
    assert torch.equal(got, tqr.ResearchQuantInference(tqp, device="cpu",
                                                       fused_enc0=True).apply(x))


def test_paired_weights_are_block_diagonal(qparams):
    """_blockdiag in each layout the port keeps: HWIO int8, OIHW float,
    [C, O] head; made once per layer; the paired epilogue vectors twice
    over, cached apart from the unpaired ones."""
    qi = tq.QuantInference(qparams[1], device="cpu")
    w = qi._paired_weights("dec0_conv1")
    ci, co = qi._wq["dec0_conv1"].shape[2:]
    assert w.shape == (3, 3, 2 * ci, 2 * co) and w is qi._paired_weights("dec0_conv1")
    assert torch.equal(w[:, :, :ci, :co], qi._wq["dec0_conv1"])
    assert torch.equal(w[:, :, ci:, co:], qi._wq["dec0_conv1"])
    assert not w[:, :, :ci, co:].any() and not w[:, :, ci:, :co].any()
    k, b = qi._paired_weights("enc0_conv2")
    k0, b0 = qi._fconv["enc0_conv2"]
    assert torch.equal(k[:k0.shape[0], :k0.shape[1]], k0) and torch.equal(b, torch.cat([b0, b0]))
    assert not k[k0.shape[0]:, :k0.shape[1]].any()
    kh, _ = qi._paired_weights("head")
    assert torch.equal(kh[qi._head[0].shape[0]:, qi._head[0].shape[1]:], qi._head[0])
    s = qparams[1].scales["dec0_conv1:cat"]
    a1, _ = qi._epilogue_vectors("dec0_conv1", s)
    a2, _ = qi._epilogue_vectors("dec0_conv1", s, paired=True)
    assert torch.equal(a2, torch.cat([a1, a1]))
