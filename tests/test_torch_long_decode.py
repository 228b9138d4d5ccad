"""Long-decode at batch 1 on a DeviceMesh under the reference's
``seq_over_data`` rules, for the reference's ``long_500k`` archs without a
KV cache of full attention only: zamba2's shared block over a linear cache
whose sequence is sharded over "data", and RWKV-6, whose WKV state is
replicated over "data" (nothing of it is sequence-sharded).  Four CPU
ranks over gloo on ("data", "model") meshes (4, 1) and (2, 2), the cache's
43 positions cut unevenly (``tests/torch_long_ranks.py`` says what each
rank runs and reports; mixtral's ring is in
``tests/test_torch_long_decode_moe.py``).

Bounds: the sharded logits within 1e-5 of the unsharded port's and the
JAX package's (zamba2: 2e-5 against the port — six blocks of 2-3 ulps, as
``tests/test_torch_ssm_shard_zamba2.py`` records — and 1e-4 against the
reference, the unsharded port's own zamba2 bound,
``tests/test_torch_zamba2.py``); greedy streams equal.  Layer 0's K/V
depend only on the tokens, so each rank's rows of it equal the unsharded
cache's bit for bit, after the prefill and after the last step; deeper
layers carry the merge's and the mesh's summation order (within the
family's logit bound against the port).
"""
import numpy as np
import pytest

from tests import torch_long_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

FAMILIES = ("zamba2", "rwkv6")
TOL = {("zamba2", "port"): 2e-5, ("zamba2", "reference"): 1e-4,
       ("rwkv6", "port"): 1e-5, ("rwkv6", "reference"): 1e-5,
       ("mixtral", "port"): 1e-5, ("mixtral", "reference"): 1e-5}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, FAMILIES)


def cases(families):
    return [(f, m) for f in families for m in R.meshes(f)]


def check_logits(runs, family, mesh, uk, against):
    label = f"{family} {mesh} kernel={uk}"
    if against == "port":
        gaps = runs[1][f"logits {label} vs port"]
    else:
        want = runs[0][family][0]
        gaps = [float(np.abs(np.asarray(g, np.float32) - want).max())
                for g in runs[1][f"logits {label}"]]
    assert len(gaps) == R.WORLD and max(gaps) <= TOL[family, against], gaps


def check_streams(runs, family, mesh, uk):
    """Every rank's greedy stream equals the unsharded port's and the
    reference's."""
    want = runs[0][family][1]
    assert len(want) == R.STEPS + 1
    got = runs[1][f"streams {family} {mesh} kernel={uk}"]
    assert got == [[want, want]] * R.WORLD


def check_cache(runs, family, mesh, uk):
    shapes, spans = R.expected_shard(family, mesh)
    got = runs[1][f"cache {family} {mesh} kernel={uk}"]
    data_rank = [g["lo"] for g in got]
    for g in got:
        d = [s[0] for s in spans].index(g["lo"])
        assert g["local shape"] == shapes[d] and (g["lo"], g["n"]) == \
            spans[d], (g, spans)
        assert g["prefill layer 0 equal"] and g["end layer 0 equal"], g
        tol = TOL[family, "port"]
        assert g["prefill gap"] <= tol and g["end gap"] <= tol, g
    assert sorted(set(data_rank)) == sorted(s[0] for s in spans)


def check_merge(runs, family, mesh):
    """One decode step's merges: two all-reduces a shared-block (or
    attention) application, of the design's bytes — an LSE and a
    weighted output a head, far below the rank's K/V shard, which never
    travels."""
    label = f"{family} {mesh} kernel=True"
    want = R.merge_bytes(family, mesh)
    for merges in runs[1][f"merge bytes {label}"]:
        assert merges and all(m == want for m in merges), (merges, want)


def check_fault(runs, family, mesh):
    """Without the merge each rank's logits leave the bound."""
    gaps = runs[1][f"fault {family} {mesh}"]
    assert min(gaps) > 10 * TOL[family, "port"], gaps


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("family,mesh", cases(FAMILIES))
def test_sharded_long_decode_logits_equal_unsharded(runs, family, mesh, uk,
                                                    against):
    """A batch-1 prefill from position 0 and 16 greedy steps: every
    step's logits against the unsharded port's and the reference's."""
    check_logits(runs, family, mesh, uk, against)


@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("family,mesh", cases(FAMILIES))
def test_sharded_long_decode_streams_equal_unsharded(runs, family, mesh,
                                                     uk):
    check_streams(runs, family, mesh, uk)


@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", list(R.meshes("zamba2")))
def test_each_rank_holds_its_positions_of_the_cache(runs, mesh, uk):
    """Each rank's shard of zamba2's (G, 1, T, KvE, dh) cache holds
    positions ``[lo, lo + n)`` as ``torch.chunk`` cuts 43 (11, 11, 11, 10
    over 4; 22, 21 over 2) and its heads' rows, equal to those rows of the
    unsharded cache (module doc)."""
    check_cache(runs, "zamba2", mesh, uk)


@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", list(R.meshes("rwkv6")))
def test_rwkv6_state_is_whole_over_data(runs, mesh, uk):
    """RWKV-6 at batch 1: token shifts (L, 1, D) and WKV state (L, 1,
    H/tp, dh, dh) on every rank — replicated over "data", heads over
    "model"."""
    (dp, tp), _ = R.meshes("rwkv6")[mesh]
    cfg = R.port_cfg("rwkv6")
    L, D, H = cfg.n_layers, cfg.d_model, cfg.n_heads
    want = {"shift_t": [L, 1, D], "shift_c": [L, 1, D],
            "wkv": [L, 1, H // tp, D // H, D // H]}
    assert runs[1][f"state rwkv6 {mesh} kernel={uk}"] == [want] * R.WORLD


@pytest.mark.parametrize("mesh", list(R.meshes("zamba2")))
def test_the_merge_carries_an_lse_and_an_output_a_head(runs, mesh):
    check_merge(runs, "zamba2", mesh)


@pytest.mark.parametrize("mesh", list(R.meshes("zamba2")))
def test_the_local_output_without_the_merge_fails(runs, mesh):
    check_fault(runs, "zamba2", mesh)


def test_a_cache_placed_as_before_is_refused_and_now_accepted(runs):
    """Before the long-decode rules were wired, a batch-1 state kept every
    "data" placement replicated, its cache's sequence with it, and the
    attention layer refused that layout on a mesh whose "data" holds 4
    ranks; the state placed now passes."""
    assert runs[1]["refused before"] == [True] * R.WORLD
    assert runs[1]["refused now"] == [False] * R.WORLD
