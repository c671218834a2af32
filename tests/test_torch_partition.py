"""The port's partitioning rules (``sharding/partition.py``) and the logical
half of ``sharding/api.py`` against the JAX package's.

  * ``leaf_spec``/``param_specs`` (with and without a leading client
    axis), ``batch_specs`` of every step's inputs, ``cache_specs`` (both
    ``kv_seq_shard``) and ``paged_cache_specs`` (mask and kernel) equal the
    JAX package's for every config of ``configs/``, full and reduced, on
    fake meshes {data 4, model 1/2/4/16} and {pod 2, data 16, model 16}
    (the JAX test's ``FakeMesh`` style: only ``shape`` is read). The port
    builds its shapes on the ``meta`` device, the JAX package with
    ``eval_shape``, so the shapes are compared too.
  * ``spec_for`` under ``logical_axis_rules`` equals the JAX package's;
    ``constrain`` returns its input, inside a context and outside.
  * The execution layout: which leaves the port shards (head- and
    channel-granular; Hymba's 25 heads whole at m 2), the leaves cut a
    half at a time, and ``shard_params`` then ``gather_params`` bitwise
    for every family on a spawned 2-rank gloo world.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JShape
from repro.models.model import build_model as jax_build_model
from repro.sharding import api as japi
from repro.sharding import partition as jpart
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import FederatedMesh, spawn
from repro_torch.models import transformer
from repro_torch.models.model import build_model, input_specs, params_struct
from repro_torch.sharding import api, partition

torch.set_num_threads(2)

ARCHS = list_archs()
MESHES = [{"data": 4, "model": m} for m in (1, 2, 4, 16)] + [
    {"pod": 2, "data": 16, "model": 16}]


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _cfgs(name, reduced):
    j, t = jax_get_arch(name), get_arch(name)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in kp)


def _jax_flat(tree):
    """{path: leaf} of a JAX pytree whose leaves are specs or structs."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out[_path(kp)] = tuple(leaf) if isinstance(leaf, P) else tuple(leaf.shape)
    return out


def _port_leaves(tree):
    """Leaves of the port's nested caches in field order (None skipped),
    as the JAX package flattens its NamedTuples."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for t in tree for x in _port_leaves(t)]
    return [tree]


@pytest.fixture(scope="module")
def structs():
    """{(arch, reduced): (jax params struct, port meta params)}."""
    out = {}
    for name in ARCHS:
        for reduced in (False, True):
            jc, tc = _cfgs(name, reduced)
            jm = jax_build_model(jc)
            if jc.family == "toy":  # their init takes no abstract key: run it
                jp = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                  jm.init(jax.random.PRNGKey(0)))
            else:
                jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
            out[name, reduced] = (jm, jp, build_model(tc, device="meta"))
    return out


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(structs, arch, reduced):
    jm, jp, tm = structs[arch, reduced]
    tp = params_struct(tm)
    assert _jax_flat(jp) == {k: tuple(v.shape) for k, v in tp.items()}
    for shape in MESHES:
        mesh = FakeMesh(shape)
        want = _jax_flat(jpart.param_specs(jp, mesh))
        assert partition.param_specs(tp, mesh) == want, (arch, shape)
        for path, leaf in tp.items():  # the unstacked rule alone
            extra = partition._stack_depth(path)
            assert partition.leaf_spec(path, tuple(leaf.shape[extra:]), mesh) == tuple(
                jpart.leaf_spec(path, tuple(leaf.shape[extra:]), mesh)), path
    # a leading client axis: divisible and not
    mesh = FakeMesh({"data": 4, "model": 2})
    for C in (4, 3):
        js = jax.tree.map(lambda s: jax.ShapeDtypeStruct((C,) + s.shape, s.dtype), jp)
        ts = {k: torch.empty((C,) + tuple(v.shape), device="meta") for k, v in tp.items()}
        assert partition.param_specs(ts, mesh, leading=("data",)) == _jax_flat(
            jpart.param_specs(js, mesh, leading=("data",)))


def _jshape(kind):
    return JShape("t", 64, 8, kind), ShapeConfig("t", 64, 8, kind)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(structs, arch, reduced):
    jm, _, tm = structs[arch, reduced]
    jc, tc = jm.config, tm.config
    kinds = ("train",) if tc.family == "toy" else ("train", "prefill", "decode")
    for kind in kinds:
        js, ts = _jshape(kind)
        jin, tin = jm.input_specs(js), input_specs(tc, ts)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tin.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jin.items()}
        for shape in MESHES:
            mesh = FakeMesh(shape)
            assert partition.batch_specs(tin, mesh) == {
                k: tuple(v) for k, v in jpart.batch_specs(jin, mesh).items()}
    if jm.init_cache is None:
        return
    B, S = 8, 64
    jcache = jax.eval_shape(lambda: jm.init_cache(B, S))
    tcache = transformer.init_cache(tc, B, S, device="meta")
    jleaves = jax.tree.leaves(jcache)
    tleaves = _port_leaves(tcache)
    assert [tuple(x.shape) for x in tleaves] == [tuple(x.shape) for x in jleaves]
    for shape in MESHES:
        mesh = FakeMesh(shape)
        for kv_seq in (False, True):
            want = [tuple(s) for s in jax.tree.leaves(
                jpart.cache_specs(jcache, mesh, kv_seq_shard=kv_seq),
                is_leaf=lambda x: isinstance(x, P))]
            assert _port_leaves(partition.cache_specs(tcache, mesh, kv_seq_shard=kv_seq)) \
                == want, (shape, kv_seq)
    if jm.init_paged_cache is None or tc.family == "ssm":
        return
    jpc = jax.eval_shape(lambda: jm.init_paged_cache(B, 32, 16))
    tpc = transformer.init_paged_cache(tc, B, 32, 16, device="meta")
    assert [tuple(x.shape) for x in _port_leaves(tpc)] == [
        tuple(x.shape) for x in jax.tree.leaves(jpc)]
    for shape in MESHES:
        mesh = FakeMesh(shape)
        for cu in ("mask", "kernel"):
            want = [tuple(s) for s in jax.tree.leaves(
                jpart.paged_cache_specs(jpc, mesh, cache_update=cu),
                is_leaf=lambda x: isinstance(x, P))]
            assert _port_leaves(partition.paged_cache_specs(tpc, mesh, cache_update=cu)) \
                == want, (shape, cu)


LOGICAL = [((8, 64, 128), ("batch", None, "ff")), ((8, 40, 16), ("batch", "heads", None)),
           ((3, 512), ("client", "vocab")), ((16, 6, 64), ("batch", "experts", "embed")),
           ((4, 4), ("kv_heads", "seq")), ((2, 30), (None, "ff"))]


@pytest.mark.parametrize("rules", [None, {"batch": None}, {"ff": ("data", "model")}])
def test_spec_for_equals_jax_under_logical_axis_rules(rules):
    for shape in MESHES:
        mesh = FakeMesh(shape)
        for dims, logical in LOGICAL:
            with japi.logical_axis_rules(mesh, rules):
                want = japi.spec_for(dims, logical)
            with api.logical_axis_rules(mesh, rules):
                got = api.spec_for(dims, logical)
                assert api.current_mesh() is mesh
            assert got == tuple(want), (shape, dims, logical)
    assert api.spec_for((4,), ("ff",)) is None and api.current_mesh() is None
    assert set(api.DEFAULT_RULES.items()) == set(japi.DEFAULT_RULES.items())


def test_constrain_is_a_no_op_in_and_out_of_a_context():
    x = torch.ones(4, 4)
    assert api.constrain(x, "batch", None) is x
    with api.logical_axis_rules(FakeMesh({"data": 2, "model": 2})):
        assert api.constrain(x, "batch", "ff") is x


def test_collectives_are_the_identity_without_a_model_axis():
    x = torch.randn(3, 4)
    for f in (api.copy_in, api.reduce_out, api.gather_last):
        assert f(x) is x
    mesh = FederatedMesh(("data", "model"), (2, 1), rank=0, device=torch.device("cpu"),
                         group=None)
    with api.logical_axis_rules(mesh):
        assert api.model_size() == 1
        for f in (api.copy_in, api.reduce_out, api.gather_last):
            assert f(x) is x


def _lay(name, m, reduced=False):
    cfg = get_arch(name)
    return partition.layout(cfg.reduced() if reduced else cfg, m)


def test_layout_is_head_granular():
    # StarCoder2-3B: Hq 24, Hkv 2, d_ff 12288, V 49152 (tied? no)
    lay = _lay("starcoder2-3b", 2)
    assert lay.attn and (lay.heads, lay.kv_heads) == (12, 1) and lay.mlp and lay.embed
    lay = _lay("starcoder2-3b", 4)  # Hkv 2 does not divide 4: attention whole
    assert not lay.attn and (lay.heads, lay.kv_heads) == (24, 2) and lay.mlp
    # Qwen1.5-32B at 16: 40 heads do not divide, JAX shards w_q/w_k mid-head (P12)
    cfg = get_arch("qwen1.5-32b")
    lay = partition.layout(cfg, 16)
    assert not lay.attn
    assert jpart.leaf_spec("layers/attn/w_q", (cfg.d_model, cfg.q_dim),
                           FakeMesh({"model": 16})) == P(None, "model")
    # granite-moe: its experts on E; qwen2-moe's 60 on 16: each expert on its f
    g = _lay("granite-moe-1b-a400m", 2)
    assert g.experts == "experts" and g.experts_local == get_arch(
        "granite-moe-1b-a400m").num_experts // 2
    q = partition.layout(get_arch("qwen2-moe-a2.7b"), 16)
    assert q.experts == "ff" and q.experts_local == 60 and q.shared
    # Hymba at m 2: 25 query heads do not divide, so attention stays whole
    # on every rank while the MLP (5504) and the SSM (d_in 3200) split
    hy = _lay("hymba-1.5b", 2)
    assert not hy.attn and (hy.heads, hy.kv_heads) == (25, 5) and hy.mlp
    assert hy.ssm and hy.ssm_channels == 1600
    cfg = get_arch("hymba-1.5b")
    keys = partition.sharded_keys(params_struct(build_model(cfg, device="meta")), hy)
    assert "layers/ssm/w_in" in keys and "layers/attn/w_q" not in keys
    assert jpart.leaf_spec("layers/attn/w_q", (cfg.d_model, cfg.q_dim),
                           FakeMesh({"model": 2})) == P(None, "model")  # JAX cuts it (P12)
    # the split halves: x ‖ gate and x ‖ output gate, a half at a time
    assert partition.halves("layers/ssm/w_in") == partition.halves("xlstm/m/w_up") == 2
    assert partition.halves("layers/mlp/w_up") == partition.halves("xlstm/s/w_x") == 1
    # xLSTM-1.3B: 4 heads, 2 a rank; w_r cut on H where JAX keeps it whole
    xl = _lay("xlstm-1.3b", 2)
    assert xl.xlstm and xl.xlstm_heads == 2 and not xl.attn
    assert partition.exec_dim("xlstm/s/w_r", 5, xl) == 2
    assert not partition.layout(get_arch("xlstm-1.3b"), 8).xlstm  # H 4 does not divide 8
    # toy: every leaf whole
    cnn = get_arch("cnn-cifar10")
    assert not partition.sharded_keys(params_struct(build_model(cnn, device="meta")),
                                      partition.layout(cnn, 4))


HALVED = [("hymba-1.5b", "layers/ssm/w_in"), ("xlstm-1.3b", "xlstm/m/w_up"),
          ("xlstm-1.3b", "xlstm/m/w_if"), ("xlstm-1.3b", "xlstm/m/b_if")]


@pytest.mark.parametrize("arch,path", HALVED)
def test_a_halved_leaf_is_cut_a_half_at_a_time(arch, path):
    """x and gate (SSM ``w_in``), x and output gate (mLSTM ``w_up``), input
    and forget gates (mLSTM ``w_if``, ``b_if``): rank r holds its slice of
    each half, which a contiguous cut of the whole dim (the JAX spec's, P12)
    would not give."""
    cfg = get_arch(arch).reduced()
    full = build_model(cfg, device="cpu").init(0)[path]
    d = partition.exec_dim(path, full.dim(), partition.layout(cfg, 2))
    assert d == full.dim() - 1 and partition.halves(path) == 2
    half = full.shape[d] // 2
    first, second = full.narrow(d, 0, half), full.narrow(d, half, half)
    n = half // 2
    for r in range(2):
        want = torch.cat([first.narrow(d, r * n, n), second.narrow(d, r * n, n)], d)
        got = partition.piece(full, d, 2, r, 2)
        assert torch.equal(got, want)
    parts = [partition.piece(full, d, 2, r, 2) for r in range(2)]
    assert torch.equal(partition.unpiece(parts, d, 2), full)
    assert not torch.equal(parts[0], full.narrow(d, 0, half))


ROUND_TRIP = ["granite-moe-1b-a400m", "starcoder2-3b", "qwen1.5-32b", "hymba-1.5b",
              "xlstm-1.3b", "whisper-medium", "phi-3-vision-4.2b"]


def _round_trips():
    mesh = FederatedMesh(("data", "model"), (1, 2), rank=torch.distributed.get_rank(),
                         device=torch.device("cpu"), group=None,
                         model_group=torch.distributed.group.WORLD)
    out = {}
    for arch in ROUND_TRIP:
        cfg = get_arch(arch).reduced()
        full = build_model(cfg, device="cpu").init(0)
        local = partition.shard_params(full, mesh, cfg)
        back = partition.gather_params(local, mesh, cfg)
        out[arch] = dict(full=full, local={k: v.clone() for k, v in local.items()}, back=back)
    return out


@pytest.fixture(scope="module")
def round_trips():
    return spawn(_round_trips, 2, "gloo", timeout_s=120)


@pytest.mark.parametrize("arch", ROUND_TRIP)
def test_shard_then_gather_is_bitwise(round_trips, arch):
    cfg = get_arch(arch).reduced()
    lay = partition.layout(cfg, 2)
    keys = partition.sharded_keys(round_trips[0][arch]["full"], lay)
    assert keys and "layers/norm1/scale" not in keys
    for r, outs in enumerate(round_trips):
        o = outs[arch]
        for k, v in o["full"].items():
            assert torch.equal(o["back"][k], v), (r, k)
            d = partition.exec_dim(k, v.dim(), lay)
            if d is None:
                assert torch.equal(o["local"][k], v)
            else:
                piece = partition.piece(v, d, partition.halves(k), r, 2)
                assert o["local"][k].shape[d] == v.shape[d] // 2
                assert torch.equal(o["local"][k], piece), (r, k)
