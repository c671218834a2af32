"""The message-passing prototype and its wire codecs in the port against the
JAX package: ``core/wire.py``, the engine's half-round entry points, and
``fed/prototype.py``'s server and clients on both dispatch fabrics.

Inputs are made with numpy from a seed; params are carried over with
``repro_torch.bridge``. Bars:
  * codec payloads (int8 buffers and scales, top-k indices and values,
    ties included), payload bytes, the wire's byte counters and tau
    traces: exactly equal;
  * the engine halves: G, g0 and new params atol 1e-6, beta/delta rtol
    1e-3 atol 1e-5, loss0 and tau_k rtol 1e-5 (tests/test_round_engine.py's
    round bars);
  * the prototype's params after 4 rounds: atol 1e-6, the JAX package's
    own bar between its fabrics (tests/test_simulator.py).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.data import synthetic as jsyn
from repro.fed import prototype as jproto
from repro.models.model import build_model_by_name as jax_build
from repro_torch.core import wire as twire
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fed import prototype as tproto
from repro_torch.models.model import build_model_by_name
from test_torch_fed_run import _np, _t

torch.set_num_threads(2)

SPECS = ["identity", "int8", "topk:3", "topk:1000"]


@pytest.fixture(scope="module")
def svm():
    jm = jax_build("svm-mnist")
    return jm, build_model_by_name("svm-mnist", device="cpu"), jm.init(jax.random.PRNGKey(0))


def _tree(seed, lead=()):
    """A flat tree with tied magnitudes (ties across signs and positions),
    an all-zero leaf and a leaf smaller than k."""
    r = np.random.RandomState(seed)
    a = r.randn(*lead, 4, 5).astype(np.float32)
    a[..., 0, :3] = 1.5
    a[..., 2, 1] = -1.5
    b = np.tile(np.float32([1.0, -1.0, 1.0, 0.5, -1.0]), lead + (1,))
    return {"a": a, "b": b, "c": np.zeros(lead + (3,), np.float32),
            "d": r.randn(*lead, 2).astype(np.float32)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_payload_equal(tp, jp):
    if isinstance(jp, dict):
        assert sorted(tp) == sorted(jp)
        for k in jp:
            _assert_payload_equal(tp[k], jp[k])
        return
    assert str(tp.dtype).split(".")[-1] == str(np.asarray(jp).dtype)
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_codec_payload_matches_jax(spec):
    tree = _tree(0)
    jc, tc = jwire.make_codec(spec), twire.make_codec(spec)
    assert tc.name == jc.name and tc.is_identity == jc.is_identity
    tp, jp = tc.encode(_tt(tree)), jc.encode(_j(tree))
    _assert_payload_equal(tp, jp)
    assert tproto._tree_bytes(tp) == jproto._tree_bytes(jp)
    assert tc.payload_nbytes(_tt(tree)) == jc.payload_nbytes(_j(tree))
    assert tc.payload_nbytes(tree) == jc.payload_nbytes(tree)  # numpy templates too
    _assert_payload_equal(tc.decode(tp, _tt(tree)), jc.decode(jp, _j(tree)))
    if spec.startswith("topk:3"):  # ties: the lower index first
        np.testing.assert_array_equal(_np(tp["idx"]["b"]), [0, 1, 2])


@pytest.mark.parametrize("spec", ["identity", "int8", "topk:3"])
def test_wire_fold_matches_jax(spec):
    """Error feedback over stacked rows of 3 clients, twice (the second
    fold starts from the first's residuals)."""
    ups, res = _tree(1, (3,)), {k: 0.1 * v for k, v in _tree(2, (3,)).items()}
    jc, tc = jwire.make_codec(spec), twire.make_codec(spec)
    jr, tr = _j(res), _tt(res)
    for _ in range(2):
        jdec, jr = jwire.wire_fold(jc, _j(ups), jr)
        tdec, tr = twire.wire_fold(tc, _tt(ups), tr)
        _assert_payload_equal(tdec, jdec)
        _assert_payload_equal(tr, jr)


def test_make_codec_specs_and_errors():
    for spec in ("none", "", None, "identity", "int8", "topk:5"):
        tc, jc = twire.make_codec(spec), jwire.make_codec(spec)
        assert (tc.name, tc.is_identity) == (jc.name, jc.is_identity)
    codec = twire.TopKCodec(2)
    assert twire.make_codec(codec) is codec and twire.make_codec("topk:5").k == 5
    for bad, match in (("topk:x", "top-k"), ("topk:0", "k >= 1"), ("gzip", "unknown wire")):
        for mod in (twire, jwire):
            with pytest.raises(ValueError, match=match):
                mod.make_codec(bad)


# ---------------------------------------------------------------------------
# the engine's half-round entry points
# ---------------------------------------------------------------------------


def _batches(seed, lead):
    r = np.random.RandomState(seed)
    return dict(x=r.randn(*lead, 8, 784).astype(np.float32),
                y=r.randint(0, 2, lead + (8,)).astype(np.int32))


def _half_engines(svm, mode="fedveca", tau_max=5):
    return (JaxRoundEngine(svm[0].loss, JaxEngineConfig(mode=mode, eta=0.05, tau_max=tau_max,
                                                        donate=False), num_clients=4),
            RoundEngine(svm[1].loss, EngineConfig(mode=mode, eta=0.05, tau_max=tau_max),
                        num_clients=4))


def _assert_reply(t, j):
    for part in ("G", "g0"):
        for k in j[part]:
            np.testing.assert_allclose(_np(t[part][k]), np.asarray(j[part][k]), atol=1e-6,
                                       rtol=0, err_msg=f"{part} {k}")
    for k in ("beta", "delta"):
        np.testing.assert_allclose(_np(t[k]), np.asarray(j[k]), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(_np(t["loss0"]), np.asarray(j["loss0"]), rtol=1e-5)


def test_client_update_matches_jax(svm):
    jeng, teng = _half_engines(svm)
    b = _batches(0, (3,))
    j = jeng.client_update(svm[2], {k: jnp.asarray(v) for k, v in b.items()}, 3, 0.7)
    t = teng.client_update(_t(svm[2]), _tt(b), 3, 0.7)
    assert t["beta"].dim() == 0 and t["G"]["w"].shape == svm[2]["w"].shape
    _assert_reply(t, j)


def test_client_update_many_matches_jax(svm):
    jeng, teng = _half_engines(svm)
    b = _batches(1, (3, 5))
    taus = np.array([5, 2, 3], np.int32)
    j = jeng.client_update_many(svm[2], {k: jnp.asarray(v) for k, v in b.items()}, taus, 0.7)
    t = teng.client_update_many(_t(svm[2]), _tt(b), taus, 0.7)
    _assert_reply(t, j)
    one = teng.client_update(_t(svm[2]), {k: v[1, :2] for k, v in _tt(b).items()}, 2, 0.7)
    for k in one["G"]:  # padding a stack past tau changes nothing
        torch.testing.assert_close(t["G"][k][1], one["G"][k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["fedveca", "fedavg"])
def test_server_aggregate_and_weighted_average_match_jax(svm, mode):
    jeng, teng = _half_engines(svm, mode)
    r = np.random.RandomState(2)
    G = {k: r.randn(4, *np.shape(v)).astype(np.float32) for k, v in svm[2].items()}
    tau, p = np.array([5, 2, 3, 4], np.int32), np.float32([0.4, 0.1, 0.3, 0.2])
    jp, jtk = jeng.server_aggregate(svm[2], _j(G), tau, p)
    tp, ttk = teng.server_aggregate(_t(svm[2]), _tt(G), tau, p)
    for k in jp:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(ttk), np.asarray(jtk), rtol=1e-6)
    jw, tw = jeng.weighted_average(_j(G), p), teng.weighted_average(_tt(G), p)
    for k in jw:
        np.testing.assert_allclose(_np(tw[k]), np.asarray(jw[k]), atol=1e-6, rtol=0)
    scaffold = RoundEngine(svm[1].loss, EngineConfig(mode="scaffold"))
    with pytest.raises(NotImplementedError, match="scaffold"):
        scaffold.server_aggregate(_t(svm[2]), _tt(G), tau, p)


# ---------------------------------------------------------------------------
# the prototype
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proto_data():
    orig = tsyn.make_classification(1000, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    parts = tpart.partition_case3(orig.y, 5, seed=0)
    p = np.array([len(s) for s in parts], float)
    return [(train.x[s], train.y[s]) for s in parts], p / p.sum()


def _servers(svm, proto_data, batched, wire):
    data, p = proto_data
    jcs = [jproto.FedVecaClient(i, svm[0], jsyn.Dataset(x, y), batch_size=8, eta=0.05)
           for i, (x, y) in enumerate(data)]
    tcs = [tproto.FedVecaClient(i, svm[1], tsyn.Dataset(x, y), batch_size=8, eta=0.05)
           for i, (x, y) in enumerate(data)]
    jsrv = jproto.FedVecaServer(svm[0], jcs, p, eta=0.05, tau_max=6, batched=batched, wire=wire)
    tsrv = tproto.FedVecaServer(svm[1], tcs, p, eta=0.05, tau_max=6, batched=batched, wire=wire)
    jsrv.params, tsrv.params = svm[2], _t(svm[2])
    return jsrv, tsrv


@pytest.mark.parametrize("wire", ["none", "int8", "topk:200"])
@pytest.mark.parametrize("batched", [True, False])
def test_prototype_matches_jax(svm, proto_data, batched, wire):
    """4 rounds (tau_max 6 clips the A_min client's 19-or-20 boundary):
    taus every round, both byte counters and the uplink bytes of each
    round exactly equal, params within 1e-6; then the STOP flags."""
    jsrv, tsrv = _servers(svm, proto_data, batched, wire)
    for k in range(4):
        jrow, trow = jsrv.round(), tsrv.round()
        np.testing.assert_array_equal(trow["tau"], jrow["tau"], err_msg=f"round {k}")
        assert (tsrv.bytes_sent, tsrv.bytes_recv) == (jsrv.bytes_sent, jsrv.bytes_recv)
        assert trow["wire_bytes"] == jrow["wire_bytes"] and trow["wire"] == jrow["wire"]
        np.testing.assert_allclose(trow["L"], jrow["L"], rtol=1e-5)
    assert any(np.any(r["tau"] != 2) for r in tsrv.history)
    for k in jsrv.params:
        np.testing.assert_allclose(_np(tsrv.params[k]), np.asarray(jsrv.params[k]), atol=1e-6,
                                   rtol=0)
    jsrv.run(0)
    tsrv.run(0)
    assert tsrv.bytes_sent == jsrv.bytes_sent
    assert all((c._engine is None) == batched for c in tsrv.clients)


def test_batched_fabric_equals_serial(svm, proto_data):
    """The port against itself, as tests/test_simulator.py holds the JAX
    package's fabrics: taus and bytes equal, params within 1e-6, and the
    batched fabric builds no per-client engine."""
    outs = {}
    for batched in (False, True):
        _, srv = _servers(svm, proto_data, batched, "none")
        taus = [srv.round()["tau"] for _ in range(4)]
        outs[batched] = (taus, srv.bytes_sent, srv.bytes_recv, srv.params, srv.clients)
    for a, b in zip(outs[True][0], outs[False][0]):
        np.testing.assert_array_equal(a, b)
    assert outs[True][1:3] == outs[False][1:3]
    for k in outs[True][3]:
        torch.testing.assert_close(outs[True][3][k], outs[False][3][k], atol=1e-6, rtol=0)
    assert all(c._engine is None for c in outs[True][4])


def test_prototype_cli_runs_on_the_cpu_and_defaults_to_cuda(monkeypatch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tproto.main(["--device", "cpu", "--rounds", "2", "--wire", "int8"])
    text = out.getvalue()
    assert "round   1: tau=" in text and "wire traffic" in text and "wire=int8" in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tproto.main(["--rounds", "1"])
