"""The port's Viterbi decoders and transition matrices against the JAX package on the CPU.

Tolerances: states equal (both take the first maximum of the same float32
sums; the inputs here have no near-ties), log probabilities to 1e-5
relative (XLA may reorder a reduction), transition matrices to 1e-12 (the
same float64 numpy). The JAX package decodes in float32 whatever it is
given; the port decodes float64 input in float64, so the float64 cases
compare against the JAX package at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu import sequence as jax_sequence

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import viterbi as port_viterbi

LOGP_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _probs(S, T, lead=(), seed=0, columns=False):
    p = np.random.RandomState(seed).rand(*lead, S, T)
    if columns:
        p /= p.sum(axis=-2, keepdims=True)
    return p.astype(np.float32)


@pytest.mark.parametrize("S,T", [(2, 1), (5, 40), (9, 200)])
def test_plain_scan_matches_the_jax_scan(S, T):
    rng = np.random.RandomState(S)
    lp = np.log(rng.rand(3, T, S)).astype(np.float32)
    lt_ = np.log(rng.rand(S, S)).astype(np.float32)
    lt_[rng.rand(S, S) < 0.3] = -np.inf  # pruned transitions
    lt_[0] = np.log(1.0 / S)  # a row of equal entries: ties go to the first state
    lpi = np.log(np.full(S, 1.0 / S)).astype(np.float32)
    states, logp = port_viterbi.viterbi_reference(torch.from_numpy(lp), torch.from_numpy(lt_),
                                                  torch.from_numpy(lpi))
    states_j, logp_j = jax_sequence._viterbi_scan(jnp.asarray(lp), jnp.asarray(lt_),
                                                  jnp.asarray(lpi))
    np.testing.assert_array_equal(states.numpy(), np.asarray(states_j))
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), rtol=LOGP_RTOL)


def test_plain_scan_breaks_ties_to_the_first_state():
    S, T = 4, 6
    lp = torch.zeros(1, T, S)
    states, logp = port_viterbi.viterbi_reference(lp, torch.zeros(S, S), torch.zeros(S))
    assert states.tolist() == [[0] * T] and float(logp) == 0.0


@pytest.mark.parametrize("kw", [{}, {"return_logp": True}, {"p_init": np.array([0.7, 0.1, 0.1,
                                                                               0.05, 0.05])},
                                {"transition_min_prob": 0.1, "return_logp": True}],
                         ids=["states", "logp", "p_init", "pruned"])
def test_viterbi_matches_jax(kw):
    prob = _probs(5, 60, lead=(2,))
    trans = L.sequence.transition_local(5, 3)
    got = L.sequence.viterbi(prob, trans, **kw)
    want = lt.sequence.viterbi(prob, trans, **kw)
    if kw.get("return_logp"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=LOGP_RTOL)
        got, want = got[0], want[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_viterbi_discriminative_and_binary_match_jax():
    prob = _probs(4, 50, lead=(3,), columns=True)
    trans = L.sequence.transition_cycle(4, 0.7)
    for kw in ({}, {"p_state": np.array([0.4, 0.3, 0.2, 0.1]), "return_logp": True}):
        got = L.sequence.viterbi_discriminative(prob, trans, **kw)
        want = lt.sequence.viterbi_discriminative(prob, trans, **kw)
        if kw:
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=LOGP_RTOL)
            got, want = got[0], want[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    binp = _probs(3, 50, seed=1)
    for kw in ({}, {"p_state": [0.2, 0.5, 0.7], "p_init": [0.3, 0.3, 0.6], "return_logp": True},
               {"transition_min_prob": 0.05}):
        trans2 = np.stack([L.sequence.transition_loop(2, p) for p in (0.6, 0.8, 0.9)]) \
            if kw.get("return_logp") else L.sequence.transition_loop(2, 0.8)
        got = L.sequence.viterbi_binary(binp, trans2, **kw)
        want = lt.sequence.viterbi_binary(binp, trans2, **kw)
        if kw.get("return_logp"):
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=LOGP_RTOL)
            got, want = got[0], want[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float64_input_decodes_in_float64():
    prob = _probs(6, 80, seed=2).astype(np.float64)
    trans = L.sequence.transition_loop(6, 0.6)
    states, logp = L.sequence.viterbi(prob, trans, return_logp=True)
    assert logp.dtype == torch.float64 and states.dtype == torch.int32
    states_j, logp_j = lt.sequence.viterbi(prob, trans, return_logp=True)
    np.testing.assert_array_equal(states.numpy(), np.asarray(states_j))
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), rtol=LOGP_RTOL)


def test_decoders_reject_what_jax_rejects():
    prob = _probs(3, 10)
    good = L.sequence.transition_uniform(3)
    for bad in (np.ones((3, 3)), -good, np.ones((2, 2)) / 2):
        with pytest.raises(L.ParameterError):
            L.sequence.viterbi(prob, bad)
    with pytest.raises(L.ParameterError):
        L.sequence.viterbi(prob * 3, good)
    with pytest.raises(L.ParameterError):
        L.sequence.viterbi(prob, good, p_init=np.array([1.0, 1.0, 1.0]))
    with pytest.raises(L.ParameterError):
        L.sequence.viterbi(prob, np.eye(3), transition_min_prob=-1.0)
    with pytest.raises(L.ParameterError, match="Empty transition"):
        L.sequence.viterbi(prob, L.sequence.transition_local(3, 1), transition_min_prob=1.5)
    with pytest.raises(L.ParameterError):
        L.sequence.viterbi_discriminative(prob, good)
    with pytest.raises(L.ParameterError):
        L.sequence.viterbi_binary(prob, np.ones((2, 2, 2)) / 2)


def test_viterbi_kernel_refusals():
    lp, lt_, lpi = torch.zeros(2, 5, 3), torch.zeros(3, 3), torch.zeros(3)
    assert port_viterbi.kernel_refusal(lp, lt_, lpi) is None
    assert "float32" in port_viterbi.kernel_refusal(lp.double(), lt_, lpi)
    assert "(rows, frames, states)" in port_viterbi.kernel_refusal(lp[0], lt_, lpi)
    assert "log_trans" in port_viterbi.kernel_refusal(lp, torch.zeros(4, 4), lpi)
    big = port_viterbi.MAX_STATES + 1
    assert "at most" in port_viterbi.kernel_refusal(torch.zeros(1, 1, big), torch.zeros(big, big),
                                                    torch.zeros(big))
    before = port_viterbi.launches
    port_viterbi.viterbi_decode(lp, lt_, lpi)  # a CPU tensor runs the plain version
    assert port_viterbi.launches == before


def test_decoders_send_float32_to_the_kernel_wrapper_and_float64_to_the_plain_version(
        monkeypatch):
    """Float32 always reaches ``viterbi_decode`` (on the card it launches or raises, never falls back)."""
    calls = []
    wrapped = port_viterbi.viterbi_decode

    def spy(lp, lt_, lpi, runs=None):
        calls.append(lp.dtype)
        return wrapped(lp, lt_, lpi, runs)

    monkeypatch.setattr(port_viterbi, "viterbi_decode", spy)
    prob = np.random.RandomState(3).rand(3, 20)
    trans = L.sequence.transition_loop(3, 0.8)
    L.sequence.viterbi(prob.astype(np.float32), trans)
    assert calls == [torch.float32]
    L.sequence.viterbi(prob, trans)
    assert calls == [torch.float32]


@pytest.mark.parametrize("name,args", [
    ("transition_uniform", (7,)),
    ("transition_loop", (4, [0.5, 0.6, 0.7, 0.8])),
    ("transition_loop", (3, 0.9)),
    ("transition_cycle", (4, 0.8)),
    ("transition_local", (8, 5)),
    ("transition_local", (9, [1, 2, 3, 4, 5, 4, 3, 2, 1])),
])
def test_transitions_match_jax(name, args):
    for kw in ({}, {"window": "hann", "wrap": True}) if name == "transition_local" else ({},):
        got = getattr(L.sequence, name)(*args, **kw)
        want = getattr(lt.sequence, name)(*args, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    with pytest.raises(L.ParameterError):
        getattr(L.sequence, name)(0, *args[1:])
