"""Paged caches on a DeviceMesh, a page pool for each batch rank:
``ServingEngine(paged=True, part=...)`` serving llama3 (bf16-layout f32
and int8 pages) on (2, 2) and (1, 4) ("data", "model") meshes and mixtral
over "pod" on a (2, 1, 2) ("pod", "data", "model") mesh.  At the default
pool its streams, admission logs and migration logs equal the unsharded
port engine's and the JAX package's engine's; each rank's store is its
pool (L, kv_pages/dp + 1, P, KvE/tp, dh) written in place, its page ids
are its pool's, every allocator keeps its invariants, and a migration
sends only the KV rows whose "model" rank the plan changes.  At a tight
pool each batch rank waits exactly as a host replay through one
``PagedKVAllocator`` a rank says.  The ranks and expectations are
``tests/torch_mem_ranks.py``'s (its doc), and so is the planted fault
(global page ids in a rank's table)."""
import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_mem_ranks import (ENGINE, PAGE, PAGED_RUNS, WORLD,
                                   admissions_of, dp_of, drive, engine_kw,
                                   expected_store, kv_pages_of, network,
                                   port_cfg, replay_pools, start_ranks)

RUNS = tuple(PAGED_RUNS)
DEFAULT = tuple(r for r in RUNS if kv_pages_of(r) is None)
TIGHT = tuple(r for r in RUNS if kv_pages_of(r) is not None)
FAULT = "llama paged (2, 2)"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_ranks(tmp_path_factory, "paged", RUNS, FAULT)


@pytest.mark.parametrize("run", RUNS)
def test_paged_engine_on_a_mesh_is_the_continuous_engine(runs, run):
    """``make_engine("auto", paged=True, part=...)`` builds the continuous
    engine on every rank, the MoE family's too: no fallback to the wave
    engine."""
    assert runs[1][f"engine type {run}"] == ["ServingEngine"] * WORLD


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("run", DEFAULT)
def test_paged_streams_and_logs_equal_unsharded(runs, run, against):
    """At the default pool every rank streams the unsharded engine's
    greedy tokens under the stragglers and logs its admissions (step,
    slot, request, chunk, pages) and its plans, each against the
    unsharded port engine's and the JAX package's, and its waits (none)
    against the port's (the JAX package's engine counts none)."""
    want = runs[0][run]
    assert len(want[against]) == len(want["port"]) > 0
    assert runs[1][f"streams {run}"] == [want[against]] * WORLD
    assert runs[1][f"admissions {run}"] == \
        [want[f"{against} admissions"]] * WORLD
    assert runs[1][f"log {run}"] == [want[f"{against} log"]] * WORLD
    assert runs[1][f"waits {run}"] == [[want["port waits"],
                                       [0] * dp_of(run)]] * WORLD


@pytest.mark.parametrize("run", DEFAULT)
def test_a_paged_migration_is_applied(runs, run):
    """The stragglers move something: at least one applied head (or, for
    mixtral, expert) migration in every rank's log."""
    log = runs[1][f"log {run}"][0]
    assert any((e[1] and e[4]) or (e[3] and e[6]) for e in log), log


@pytest.mark.parametrize("run", RUNS)
def test_each_rank_store_is_its_pool_written_in_place(runs, run):
    """Each rank's store is its own pool of kv_pages/dp pages plus its
    sink, over its KV rows: (L, kv_pages/dp + 1, P, KvE/tp, dh) (int8
    scales without dh); every decode step, across admissions, retires
    and migrations, sees one storage."""
    assert runs[1][f"store {run}"] == [expected_store(run)] * WORLD
    assert runs[1][f"storages {run}"] == [1] * WORLD
    assert min(runs[1][f"decode steps {run}"]) > 0


@pytest.mark.parametrize("run", RUNS)
def test_page_ids_are_rank_local_and_allocators_hold(runs, run):
    """Every id in a rank's page table names a page of its own pool (or
    none: -1), and
    every (group, batch rank) allocator keeps free + live == pool with no
    page owned twice after every step, drained at the end."""
    ids = runs[1][f"largest page id {run}"]
    # at 6 pages the second data rank never admits (-1: no page mounted)
    assert all(largest < pool for largest, pool in ids)
    assert max(largest for largest, _ in ids) >= 0
    assert runs[1][f"invariants {run}"] == [True] * WORLD


@pytest.mark.parametrize("run", DEFAULT)
def test_paged_migrations_send_only_rows_that_change_rank(runs, run):
    """Per applied head migration, each rank's sent KV rows and bytes over
    its pool's values (and int8 scales) in every layer equal the rows of
    its chunk that the plan puts on another "model" rank (worked out from
    the plan in the tests), and some rows do move."""
    sent = runs[1][f"sent {run}"]
    assert sent == runs[1][f"expected sent {run}"]
    assert sum(rows for per_rank in sent for rows, _ in per_rank) > 0


@pytest.mark.parametrize("run", TIGHT)
def test_tight_pool_waits_equal_a_host_replay(runs, run):
    """At a pool of 6 or 10 pages on 2 data ranks every request finishes
    with the default pool's tokens, and each batch rank's waits and every
    admission equal an independent host replay of the admissions and
    retires through one ``PagedKVAllocator`` a rank.  The engine admits
    the queue head into the lowest free slot, which waits when its rank's
    pool is dry (at 6 pages rank 0's, at 10 rank 1's): a divergence from
    the reference's one pool (ROADMAP Queue 3)."""
    waits, admitted = replay_pools(dp_of(run), kv_pages_of(run))
    assert sum(waits) > 0
    assert runs[1][f"waits {run}"] == [[sum(waits), waits]] * WORLD
    assert runs[1][f"admissions {run}"] == [admitted] * WORLD
    assert runs[1][f"streams {run}"] == \
        [runs[0]["llama paged (2, 2)"]["port"]] * WORLD


def test_the_planted_page_id_fault_is_caught(runs):
    """The engine mounting global page ids: the ranks of data rank 1 find
    ids past their pool in their table, which the page-id test fails."""
    got = runs[1][f"fault {FAULT}"]
    assert [largest >= pool for largest, pool in got] == \
        [False, False, True, True]


@pytest.mark.parametrize("pages", [None, 8, 12])
def test_host_replay_equals_the_unsharded_engine_on_one_rank(pages):
    """The host replay the tight-pool test holds the ranks to, checked on
    one batch rank against the unsharded port engine's own waits and
    admissions (llama, f32, the runs' traffic)."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    run = "llama paged (1, 4)"
    kw = dict(engine_kw(run), kv_pages=pages or ENGINE["n_slots"]
              * ENGINE["max_seq"] // PAGE)
    eng = ServingEngine(port_cfg(run), device="cpu",
                        net=network(DeviceNetwork), **kw)
    drive(eng)
    waits, admitted = replay_pools(1, kw["kv_pages"])
    assert waits == [eng.page_waits] == eng.rank_page_waits
    assert admitted == admissions_of(eng)


def test_kv_pages_that_do_not_split_over_the_batch_ranks_are_refused():
    """A pool, or a slot group's rows, that do not split evenly over the
    mesh's batch ranks ("pod" x "data") raise before any weight is placed,
    with the numbers."""
    from repro_torch.models.partitioning import make_partitioner
    from repro_torch.serving.engine import ServingEngine
    from tests.test_torch_sharding import StandInMesh
    cfg = port_cfg("llama paged (2, 2)")
    part = make_partitioner(StandInMesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError,
                       match="2 batch ranks .* 4 rows and kv_pages=7 "):
        ServingEngine(cfg, part=part, device="cpu", paged=True,
                      page_size=PAGE, kv_pages=7, n_slots=4, max_seq=64)
    pod = make_partitioner(StandInMesh((2, 2, 1), ("pod", "data", "model")))
    with pytest.raises(ValueError,
                       match="4 batch ranks .* 2 rows and kv_pages=16 "):
        ServingEngine(cfg, part=pod, device="cpu", paged=True,
                      page_size=PAGE, n_slots=4, pipeline_k=2, max_seq=64)
