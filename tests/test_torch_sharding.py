"""The port's placement rules against the JAX package's, entry for entry.

``param_spec`` is the reference's rule table (tp, fsdp, ``pod_ep``, the
int8 ``q8``/``sc`` leaves, zero3); the port returns the reference's
``PartitionSpec`` entries as a tuple.  Every leaf of every family's
reduced params at tp 16 is held to the reference's spec — and the port's
own init and ``quantize_params`` trees must carry the reference's leaf
paths, so the rules reach them by name.  ``param_shardings``,
``batch_shardings`` and ``decode_state_shardings`` must give the
placements the reference's specs give on the same mesh dimensions; they
run here on a stand-in mesh object (names and sizes; no process group),
the real mesh is ``tests/test_torch_distributed.py``'s.  Also the axis
rules, ``make_partitioner``, ``best_mesh_shape`` and
``DeviceNetwork.from_mesh``.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core import placement_bridge as jbridge
from repro.core.network import DeviceNetwork as JaxNetwork
from repro.models import partitioning as jpart
from repro.models.api import build_model as jax_build_model
from repro.models.quantization import quantize_params as jax_quantize
from repro.runtime.elastic import best_mesh_shape as jax_best_mesh_shape
from repro_torch.configs import get_config
from repro_torch.core import placement_bridge as bridge
from repro_torch.core.network import (H100_HBM_BYTES, H100_NVLINK_BW,
                                      H100_PEAK_FLOPS_BF16, DeviceNetwork)
from repro_torch.models import partitioning as part
from repro_torch.models.api import build_model
from repro_torch.models.quantization import quantize_params
from repro_torch.runtime.elastic import best_mesh_shape
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("llama3-8b", "qwen1.5-32b", "glm4-9b", "mixtral-8x7b",
         "musicgen-large", "llama-3.2-vision-11b", "rwkv6-7b", "zamba2-2.7b",
         "paper-gpt")
TP = 16


class StandInMesh:
    """What the placement functions read of a ``DeviceMesh``: dimension
    names and sizes."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, mesh_dim=None):
        return math.prod(self.shape) if mesh_dim is None \
            else self.shape[mesh_dim]


MESHES = {"tp": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model"))}


def _cfgs(arch):
    cfg_j = reduced_config(arch)
    return cfg_j, get_config(arch).with_overrides(**dataclasses.asdict(cfg_j))


def _ref_leaves(tree):
    """{path names: shape} of a reference tree."""
    return {tuple(jbridge._path_names(path)): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, path=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (str(k),)))
        return out
    return {path: tuple(getattr(tree, "shape", ()))}


def _port_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def trees(request):
    """The reference's and the port's params of one family at tp 16 (the
    reference's as shapes), and both packages' int8 trees."""
    cfg_j, cfg_t = _cfgs(request.param)
    ref = jax.eval_shape(jax_build_model(cfg_j, tp=TP).init,
                         jax.random.PRNGKey(0))
    ref_q = jax.eval_shape(lambda k: jax_quantize(
        jax_build_model(cfg_j, tp=TP).init(k)), jax.random.PRNGKey(0))
    port = build_model(cfg_t, tp=TP, device="cpu").init(
        torch.Generator().manual_seed(0))
    port_q = None if cfg_t.family == "ssm" else quantize_params(port)
    return cfg_j, cfg_t, ref, ref_q, port, port_q


# -------------------------------------------------------------- param_spec
def test_port_init_carries_the_reference_leaf_paths(trees):
    """Names reach the rules exactly: the same leaf paths and shapes
    (tok_embed, lm_head, attn/wq..bv, w_gate/w_up/w_down/b_up, router,
    the rwkv and mamba names), int8 ``q8``/``sc`` leaves included."""
    cfg_j, _, ref, ref_q, port, port_q = trees
    assert _port_leaves(port) == _ref_leaves(ref)
    if port_q is not None:
        got = {k: v for k, v in _port_leaves(port_q).items()}
        assert got == _ref_leaves(ref_q)


@pytest.mark.parametrize("layout,fsdp,pod_ep", [
    ("tp", False, False), ("tp", True, False), ("tp", True, True),
    ("zero3", False, False)])
def test_param_spec_equals_reference_on_every_leaf(trees, layout, fsdp,
                                                   pod_ep):
    cfg_j, cfg_t, ref, ref_q, _, port_q = trees
    for tree in (ref, ref_q if port_q is not None else None):
        if tree is None:
            continue
        for names, shape in _ref_leaves(tree).items():
            kw = dict(fsdp=fsdp, pod_ep=pod_ep and cfg_j.is_moe,
                      layout=layout, shape=shape, n_devices=256)
            want = jbridge.param_spec(list(names), len(shape), cfg_j, TP,
                                      **kw)
            got = bridge.param_spec(list(names), len(shape), cfg_t, TP, **kw)
            assert got == tuple(want), (names, got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_shardings_place_as_the_reference_specs(trees, mesh, fsdp):
    """``param_shardings`` of the port's tree on a (16, 16) or (2, 16, 16)
    mesh: each leaf's placements are those of the reference's spec for
    it (MoE experts over "pod" on the multi-pod mesh)."""
    cfg_j, cfg_t, ref, _, port, _ = trees
    shape, names = MESHES[mesh]
    m = StandInMesh(shape, names)
    got = bridge.param_shardings(port, cfg_t, m, fsdp=fsdp)
    for path, leaf_shape in _ref_leaves(ref).items():
        want = jbridge.param_spec(
            list(path), len(leaf_shape), cfg_j, 16, fsdp=fsdp,
            pod_ep=cfg_j.is_moe and "pod" in names, shape=leaf_shape,
            n_devices=m.size())
        sh = _port_at(got, path)
        assert sh.mesh is m
        assert sh.placements == part.placements(m, tuple(want)), path


def test_reference_spec_cases():
    """The cases of ``tests/test_distribution.py`` and more."""
    cfg = get_config("llama3-8b")
    spec = bridge.param_spec
    assert spec(["layers", "attn", "wq"], 4, cfg, 16, fsdp=True,
                pod_ep=False) == (None, "data", "model", None)
    assert spec(["layers", "attn", "wo"], 4, cfg, 16, fsdp=False,
                pod_ep=False) == (None, "model", None, None)
    # kv weights with kv=8 < tp=16: head axis NOT sharded
    assert spec(["layers", "attn", "wk"], 4, cfg, 16, fsdp=False,
                pod_ep=False)[2] is None
    assert spec(["layers", "attn", "wk"], 4, cfg, 8, fsdp=False,
                pod_ep=False)[2] == "model"
    assert spec(["tok_embed"], 2, cfg, 16, fsdp=False,
                pod_ep=False) == ("model", None)
    mx = get_config("mixtral-8x7b")
    assert spec(["layers", "moe", "w_gate"], 4, mx, 16, fsdp=True,
                pod_ep=True) == (None, "pod", "data", "model")
    assert spec(["layers", "attn", "wq", "q8"], 4, cfg, 16, fsdp=False,
                pod_ep=False) == (None, None, "model", None)
    assert spec(["layers", "attn", "wq", "sc"], 2, cfg, 16, fsdp=False,
                pod_ep=False) == (None, None)
    assert spec(["layers", "mlp", "w_gate"], 3, cfg, 16, fsdp=False,
                pod_ep=False, layout="zero3", shape=(32, 4096, 14336),
                n_devices=256) == (None, None, ("data", "model"))
    assert spec(["layers", "attn", "wo"], 4, cfg, 16, fsdp=False,
                pod_ep=False, layout="zero3", shape=(32, 32, 128, 4096),
                n_devices=256) == (None, None, None, ("data", "model"))
    # qwen1.5-32b at tp 16: 40 heads padded to 48 keep their KV sharded
    qw = get_config("qwen1.5-32b")
    assert spec(["layers", "attn", "bk"], 3, qw, 16, fsdp=False,
                pod_ep=False) == (None, "model", None)
    for s in ((None, "data", "model", None), (None, "pod", "data", "model")):
        jp = P(*s)
        assert tuple(jp) == s


# ----------------------------------------------------- batch and state
def _jax_mesh(names):
    return jax.make_mesh((1,) * len(names), names)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("layout", ["tp", "zero3"])
def test_batch_shardings_equal_reference(mesh, layout):
    shape, names = MESHES[mesh]
    batch = {"tokens": np.zeros((8, 32), np.int32),
             "labels": np.zeros((8, 32), np.int32),
             "img_embeds": np.zeros((8, 4, 16), np.float32),
             "img_mask": np.zeros((8, 4), bool)}
    want = jbridge.batch_shardings(batch, _jax_mesh(names), layout=layout)
    m = StandInMesh(shape, names)
    got = bridge.batch_shardings(batch, m, layout=layout)
    for k in batch:
        assert got[k].placements == part.placements(m, tuple(want[k].spec))


def _states(arch):
    """(reference state shapes, port state) pairs of the family's decode
    states: lock-step and per-slot, paged and int8 where it has them."""
    cfg_j, cfg_t = _cfgs(arch)
    mj = jax_build_model(cfg_j)
    mt = build_model(cfg_t, device="cpu")
    pj = jax.eval_shape(mj.init, jax.random.PRNGKey(0))
    pt = mt.init(torch.Generator().manual_seed(0))
    kw_j, kw_t = {}, {}
    if cfg_j.family == "vlm":
        kw_j = dict(img_embeds=jax.ShapeDtypeStruct((2, 4, 64), "float32"),
                    img_mask=jax.ShapeDtypeStruct((2, 4), "bool"))
        kw_t = dict(img_embeds=torch.zeros(2, 4, 64),
                    img_mask=torch.ones(2, 4, dtype=torch.bool))
    out = [(jax.eval_shape(lambda p, kw: mj.init_decode_state(
        p, 2, 16, **kw), pj, kw_j),
            mt.init_decode_state(pt, 2, 16, **kw_t))]
    if cfg_j.family in ("dense", "moe", "audio", "vlm"):
        out.append((jax.eval_shape(lambda p, kw: mj.init_decode_state(
            p, 2, 16, per_slot=True, **kw), pj, kw_j),
            mt.init_decode_state(pt, 2, 16, per_slot=True, **kw_t)))
    if arch == "llama3-8b":
        out.append((jax.eval_shape(lambda p: mj.init_paged_state(
            p, 2, 4, 8, 2), pj), mt.init_paged_state(pt, 2, 4, 8, 2)))
        cq_j = cfg_j.with_overrides(kv_quant=True)
        cq_t = cfg_t.with_overrides(kv_quant=True)
        mqj, mqt = jax_build_model(cq_j), build_model(cq_t, device="cpu")
        out.append((jax.eval_shape(lambda p: mqj.init_decode_state(
            p, 2, 16, per_slot=True), pj),
            mqt.init_decode_state(pt, 2, 16, per_slot=True)))
    return out


@pytest.mark.parametrize("seq_over_data", [False, True])
@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b",
                                  "llama-3.2-vision-11b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_decode_state_shardings_equal_reference(arch, seq_over_data):
    """Every leaf of every decode state (k, v, k_sc, v_sc, pos, page_map,
    expert_load, img_kv, img_mask, wkv, shift_t, shift_c, ssm, conv)
    gets the reference's placement; the port's states carry the
    reference's leaf names."""
    names = ("data", "model")
    m = StandInMesh((16, 16), names)
    jm = _jax_mesh(names)
    seen = set()
    for ref_state, port_state in _states(arch):
        ref_specs = jbridge.decode_state_shardings(
            ref_state, None, jm, seq_over_data=seq_over_data)
        want = {tuple(jbridge._path_names(path)): tuple(sh.spec)
                for path, sh in jax.tree_util.tree_flatten_with_path(
                    ref_specs)[0]}
        got = bridge.decode_state_shardings(port_state, None, m,
                                            seq_over_data=seq_over_data)
        for path, spec in want.items():
            sh = _port_at(got, path)
            assert sh.placements == part.placements(m, spec), path
            seen.add(path[-1])
        port_paths = set(_port_leaves(port_state))
        assert set(want) <= port_paths | {("pos",)}, \
            set(want) - port_paths
    assert seen


# ------------------------------------------- rules and the partitioner
@pytest.mark.parametrize("kw", [{}, dict(fsdp=True), dict(seq_over_data=True),
                                dict(sp=True), dict(data_axes="data"),
                                dict(data_axes=("pod", "data"), fsdp=True)])
def test_rules_tp_equal_reference(kw):
    assert part.rules_tp(**kw) == jpart.rules_tp(**kw)


@pytest.mark.parametrize("axes", [("data",), ("data", "model"),
                                  ("pod", "data", "model")])
def test_rules_zero3_equal_reference(axes):
    assert part.rules_zero3(axes) == jpart.rules_zero3(axes)


LOGICAL = [("batch", "seq", "heads", None), ("batch", "res_seq", "d_model"),
           ("batch", "seq", "d_ff"), ("batch", "cache_seq", "kv_heads", None),
           ("heads", "kv_heads"), ("batch", "experts", None, "d_ff"),
           ("batch", "seq", "vocab"), ("batch", "ssm_heads", None, None),
           ("fsdp", "heads"), ("batch", "img_seq", "kv_heads", None)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kw", [{}, dict(fsdp=True, sp=True),
                                dict(seq_over_data=True),
                                dict(layout="zero3")])
def test_make_partitioner_equals_reference(mesh, kw):
    shape, names = MESHES[mesh]
    want = jpart.make_partitioner(_jax_mesh(names), **kw)
    m = StandInMesh(shape, names)
    got = part.make_partitioner(m, **kw)
    assert got.rules == want.rules
    for axes in LOGICAL:
        assert got.spec(axes) == tuple(want.spec(axes)), axes
        assert got.placements(axes) == part.placements(m, got.spec(axes))
    assert part.make_partitioner(None) is not None
    assert part.make_partitioner(None).mesh is None


def test_null_partitioner_leaves_tensors_alone():
    x = torch.ones(2, 3)
    assert part.NULL.constrain(x, ("batch", "seq")) is x
    assert part.NULL.spec(("batch",)) == tuple(jpart.NULL.spec(("batch",)))
    p = part.Partitioner(StandInMesh((2, 2), ("data", "model")),
                         part.rules_tp())
    assert p.constrain(x, ("batch", "d_ff")) is x   # a plain tensor


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if get_config(a).family != "dense"])
def test_a_mesh_is_refused_outside_the_dense_family(arch):
    """No family is refused a mesh any more: ``build_model`` builds the
    MoE, audio, VLM, RWKV-6 and Zamba2 families on a partitioner with one
    (ROADMAP Queue 1 #18's families), and every family takes ``NULL``.  A
    VLM's paged cache stays refused on a mesh, as without one (the
    reference has none)."""
    cfg = reduced_config(arch)
    cfg = get_config(arch).with_overrides(**dataclasses.asdict(cfg))
    mesh = part.make_partitioner(StandInMesh((2, 2), ("data", "model")))
    model = build_model(cfg, tp=2, part=mesh, device="cpu")
    assert model.part is mesh
    if cfg.family == "vlm":
        one_data = part.make_partitioner(StandInMesh((1, 2),
                                                     ("data", "model")))
        with pytest.raises(NotImplementedError, match="VLM image"):
            build_model(cfg, tp=2, part=one_data,
                        device="cpu").init_paged_cache(4, 8)
    build_model(cfg, tp=2, part=part.NULL, device="cpu")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = StandInMesh((2, 16, 16), ("pod", "data", "model"))
    assert part.placements(m, (None, ("pod", "data"), "model")) == \
        (Shard(1), Shard(1), Shard(2))
    assert part.placements(m, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="expert"):
        part.placements(StandInMesh((4,), ("data",)), (None, "expert"))


# ---------------------------------------------------- meshes and network
def test_best_mesh_shape_equals_reference():
    for n in range(1, 65):
        for prefer in (1, 2, 4, 16):
            assert best_mesh_shape(n, prefer_model=prefer) == \
                jax_best_mesh_shape(n, prefer_model=prefer)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 4), (1, 4), (2, 4, 4),
                                   (16, 16)])
def test_from_mesh_equals_reference(shape):
    kw = dict(hbm_bytes=16 * 1024 ** 3, peak_flops=197e12, link_bw=50e9,
              seed=3)
    got = DeviceNetwork.from_mesh(shape, **kw)
    want = JaxNetwork.from_mesh(shape, **kw)
    for name in ("mem_capacity", "compute_max", "compute_avail",
                 "bandwidth"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.controller == want.controller == 0
    assert got.rng.random() == want.rng.random()


def test_from_mesh_defaults_are_the_cards():
    net = DeviceNetwork.from_mesh(StandInMeshWithRanks((2, 2)))
    assert net.n_devices == 4
    assert (net.mem_capacity == H100_HBM_BYTES).all()
    assert (net.compute_max == H100_PEAK_FLOPS_BF16).all()
    # (0, 0) -> (1, 1): two hops on a 2 x 2 torus
    assert net.bandwidth[0, 3] == H100_NVLINK_BW / 2
    assert net.bandwidth[0, 1] == H100_NVLINK_BW


class StandInMeshWithRanks:
    """A ``DeviceMesh``'s rank tensor (``.mesh``), all ``from_mesh``
    reads of it."""

    def __init__(self, shape):
        self.mesh = torch.arange(math.prod(shape)).reshape(shape)


def test_mesh_helpers_want_the_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device_type=None meshes on it")
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime.elastic import ElasticMesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_debug_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticMesh([0])
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(1, 1, device_type="cpu")


def test_migration_bytes_equals_reference():
    pairs = [(0, 1, 2), (1, 3, 0), (2, 2, 1)]
    for per in (0.0, 3.5, 1 << 20):
        assert bridge.migration_bytes(pairs, per) == \
            jbridge.migration_bytes(pairs, per)
