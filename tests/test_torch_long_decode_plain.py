"""The long-decode path's pieces in one process: the decode kernels' plain
versions with their log-sum-exp output over the shards of a cache whose
sequence (a ring: its slots) is cut over devices, merged by
``partitioning.merge_partials`` (``SeqShard.merge``'s local form), against
the unsharded plain version and the JAX package's Pallas kernels run in
interpret mode, as their own tests run them (float32, ``atol=rtol=1e-5``:
only the order of the sums differs); the plain attention's LSE; the cache
writes of a sequence shard; and the placement of a batch-1 state under the
``seq_over_data`` rules, which before this slice kept the cache's
sequence whole and so was refused by the attention layer on a mesh whose
"data" holds several ranks (``tests/test_torch_long_decode.py`` runs that
refusal on 4 ranks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    decode_attention_resident as jax_decode_resident,
    decode_attention_ring_resident as jax_decode_ring)
from repro_torch.kernels.attention_plain import attention_scores, causal_mask
from repro_torch.kernels.decode_attention import (
    decode_attention_resident, decode_attention_resident_plain,
    decode_attention_ring_resident, decode_attention_ring_resident_plain)
from repro_torch.models.layers import _write_cache
from repro_torch.models.partitioning import (EMPTY_LSE, SeqShard,
                                             merge_partials)
from tests.test_torch_gpu import ring_slot_pos
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

B, H, KvE, DH = 4, 8, 2, 16
G = H // KvE
T, W, SHARDS = 64, 32, 4
TOL = dict(atol=1e-5, rtol=1e-5)
# row lengths: ending in the first shard, empty, whole, ending mid-cache
LENGTHS = (5, 0, T, 37)
# (written positions, per-row lengths = query position + 1): a wrapped
# ring holding positions 50-81, rows that see every slot, the slots of
# shard 2 only (50-54), of shards 0, 2 and 3 (50-71), and none (8-39)
RING = (2 * W + 18, (2 * W + 18, 55, 72, 40))


def _inputs(seed, extent):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, KvE, extent, DH)).astype(np.float32)
    v = rng.standard_normal((B, KvE, extent, DH)).astype(np.float32)
    rows = np.concatenate([g * G + rng.permutation(G)
                           for g in rng.permutation(KvE)]).astype(np.int32)
    return rng, q, k, v, rows


def _spans(n, shards=SHARDS):
    """(lo, count) of each shard of ``n``, cut as ``torch.chunk`` cuts."""
    chunk = -(-n // shards)
    return [(min(r * chunk, n), max(min(chunk, n - r * chunk), 0))
            for r in range(shards)]


def _merged_resident(q, k, v, lens, rows):
    """The plain resident version over each sequence shard (its local
    lengths), merged."""
    parts = []
    for lo, n in _spans(k.shape[2]):
        seq = SeqShard(lo, n, k.shape[2])
        parts.append(decode_attention_resident(
            q, k[:, :, lo:lo + n], v[:, :, lo:lo + n],
            seq.local_lengths(lens), rows, return_lse=True))
    return merge_partials(torch.stack([p[0] for p in parts]),
                          torch.stack([p[1] for p in parts])), parts


@pytest.mark.parametrize("against", ["plain", "reference"])
def test_resident_shards_merged_equal_the_whole_call(against):
    _, q, k, v, rows = _inputs(1, T)
    lens = np.asarray(LENGTHS, np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, lens, rows)]
    got, _ = _merged_resident(*t)
    if against == "plain":
        want = decode_attention_resident_plain(*t).numpy()
    else:
        want = np.asarray(jax_decode_resident(
            *(jnp.asarray(a) for a in (q, k, v, lens, rows)),
            interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[1].any()          # the length-0 row: zeros


def test_resident_lse_is_the_valid_scores_log_sum_exp():
    """The LSE in natural-log units over each row's valid positions; a
    shard past a row's length gives -1e30 and zeros, and weighs 0."""
    _, q, k, v, rows = _inputs(2, T)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    rws = torch.from_numpy(rows)
    out, lse = decode_attention_resident(qt, kt, vt, lens, rws,
                                         return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == (B, H)
    s = torch.einsum("bhd,bhtd->bht", qt[:, rows],
                     kt[:, rws.long() // G]) / DH ** 0.5
    for b, n in enumerate(LENGTHS):
        if n:
            torch.testing.assert_close(lse[b], torch.logsumexp(
                s[b, :, :n], -1), rtol=1e-6, atol=1e-6)
        else:
            assert (lse[b] == EMPTY_LSE).all() and not out[b].any()
    torch.testing.assert_close(out.to(qt.dtype), decode_attention_resident(
        qt, kt, vt, lens, rws), rtol=0, atol=0)
    _, parts = _merged_resident(qt, kt, vt, lens, rws)
    # row 0 ends in shard 0: the other shards hold no valid key
    for o, l in parts[1:]:
        assert (l[0] == EMPTY_LSE).all() and not o[0].any()


def test_one_shard_holding_every_key_merges_to_itself_bit_for_bit():
    _, q, k, v, rows = _inputs(3, T // SHARDS)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    lens = torch.tensor([16, 3, 9, 16], dtype=torch.int32)
    out, lse = decode_attention_resident(qt, kt, vt, lens,
                                         torch.from_numpy(rows),
                                         return_lse=True)
    outs = torch.stack([out] + [torch.zeros_like(out)] * 3)
    lses = torch.stack([lse] + [torch.full_like(lse, EMPTY_LSE)] * 3)
    assert torch.equal(merge_partials(outs, lses), out)
    assert torch.equal(merge_partials(outs[:1], lses[:1],
                                      torch.bfloat16), out.bfloat16())
    assert torch.equal(SeqShard(0, 16, 16).merge(out, lse), out)


@pytest.mark.parametrize("against", ["plain", "reference"])
def test_ring_slot_shards_merged_equal_the_whole_call(against):
    """A wrapped ring of 32 slots in 4 shards of 8, the whole window the
    validity rule of each: rows whose window holds every slot, slots of
    some shards only, and none (``RING``)."""
    _, q, k, v, rows = _inputs(4, W)
    n_written, lengths = RING
    lens = np.asarray(lengths, np.int32)
    slot_pos = ring_slot_pos(W, n_written).astype(np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, lens, slot_pos, rows)]
    parts = [decode_attention_ring_resident(
        t[0], t[1][:, :, lo:lo + n], t[2][:, :, lo:lo + n], t[3],
        t[4][lo:lo + n], t[5], window=W, return_lse=True)
        for lo, n in _spans(W)]
    got = merge_partials(torch.stack([p[0] for p in parts]),
                         torch.stack([p[1] for p in parts]))
    if against == "plain":
        want = decode_attention_ring_resident_plain(*t, window=W).numpy()
    else:
        want = np.asarray(jax_decode_ring(
            *(jnp.asarray(a) for a in (q, k, v, lens, slot_pos, rows)),
            window=W, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[3].any()
    empty = [(p[1][2] == EMPTY_LSE).all().item() for p in parts]
    assert any(empty) and not all(empty)


def test_ring_takes_fewer_slots_than_its_window_but_not_more():
    _, q, k, v, rows = _inputs(5, W)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    lens = torch.tensor([40] * B, dtype=torch.int32)
    pos = torch.from_numpy(ring_slot_pos(W, 40).astype(np.int32))
    out = decode_attention_ring_resident(
        args[0], args[1][:, :, :8], args[2][:, :, :8], lens, pos[:8],
        torch.from_numpy(rows), window=W)
    assert out.shape == (B, H, DH)
    with pytest.raises(ValueError, match="extent <= 16"):
        decode_attention_ring_resident(*args, lens, pos,
                                       torch.from_numpy(rows), window=16)
    with pytest.raises(ValueError, match="slot_pos"):
        decode_attention_ring_resident(
            args[0], args[1][:, :, :8], args[2][:, :, :8], lens, pos,
            torch.from_numpy(rows), window=W)


@pytest.mark.parametrize("S", [1, 5])
def test_plain_attention_lse_over_shards_merges_to_the_whole(S):
    """The model's plain attention (``attention_scores``) over a cache's
    shards, masked by each shard's positions: its float32 output without
    the flag's cast and the LSE, merged, against the whole call — a decode
    step and a chunk of 5 queries past position 0."""
    rng = np.random.default_rng(6 + S)
    q = torch.from_numpy(rng.standard_normal((1, S, H, DH)).astype(
        np.float32))
    kv = [torch.from_numpy(rng.standard_normal((1, 43, KvE, DH)).astype(
        np.float32)) for _ in range(2)]
    qpos = torch.arange(30, 30 + S)[None]
    kpos = torch.arange(43)[None]
    want = attention_scores(q, *kv, causal_mask(qpos, kpos))
    out, lse = attention_scores(q, *kv, causal_mask(qpos, kpos),
                                return_lse=True)
    assert torch.equal(out, want) and lse.shape == (1, S, H)
    parts = [attention_scores(q, kv[0][:, lo:lo + n], kv[1][:, lo:lo + n],
                              causal_mask(qpos, kpos[:, lo:lo + n]),
                              return_lse=True)
             for lo, n in _spans(43)]
    got = merge_partials(torch.stack([p[0] for p in parts]),
                         torch.stack([p[1] for p in parts]))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("n_total", [43, 64])
def test_sequence_shard_writes_land_on_the_owner_only(n_total):
    """A prefill chunk across shards, a lock-step decode write and
    per-slot writes (one row retired at T) on each shard of a cache of
    ``n_total`` positions, cut unevenly for 43: the shards put together
    equal the whole cache written alike."""
    rng = np.random.default_rng(n_total)
    whole = {"k": torch.zeros(2, n_total, KvE, DH)}
    shards = [(SeqShard(lo, n, n_total), {"k": torch.zeros(2, n, KvE, DH)})
              for lo, n in _spans(n_total)]
    writes = [(torch.from_numpy(rng.standard_normal(
        (2, 20, KvE, DH)).astype(np.float32)), 7),
        (torch.from_numpy(rng.standard_normal((2, 1, KvE, DH)).astype(
            np.float32)), 33),
        (torch.from_numpy(rng.standard_normal((2, 1, KvE, DH)).astype(
            np.float32)), torch.tensor([n_total - 1, n_total]))]
    for t, pos in writes:
        _write_cache(whole, {"k": t}, pos)
        for seq, buf in shards:
            _write_cache(buf, {"k": t}, pos, seq)
    assert torch.equal(torch.cat([b["k"] for _, b in shards], 1),
                       whole["k"])
    assert [s.owns(33) for s, _ in shards].count(True) == 1


def test_seq_shard_spans_and_lengths():
    seq = SeqShard(11, 11, 43)
    assert seq.span(7, 20) == (11, 11) and seq.span(30, 2) == (30, 0)
    assert seq.span(20, 10) == (20, 2)
    assert seq.local_lengths(torch.tensor([5, 12, 30])).tolist() == \
        [0, 1, 11]
    assert seq.owns(21) and not seq.owns(22)


def test_seq_over_data_state_places_the_sequence_over_data():
    """``transformer.state_shardings`` of a batch-1 zamba2 state under the
    long-decode rules: its cache's T over "data" and KvE over "model", the
    Mamba-2 states whole over "data" (no batch axis) — where before this
    slice the batch-1 rule replicated every "data" placement, the cache's
    sequence with it.  Without the rules the batch-1 rule stands."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner
    from repro_torch.models.transformer import state_shardings
    from tests.test_torch_sharding import StandInMesh
    from tests.torch_long_ranks import port_cfg
    mesh = StandInMesh((4, 2), ("data", "model"))
    cfg = port_cfg("zamba2")
    state = {"cache": build_model(cfg, device="cpu")._zero_state(
        1, 43, True, "meta"), "pos": 0}
    sh = state_shardings(state, cfg, make_partitioner(
        mesh, seq_over_data=True), batch=1)
    assert sh[("cache", "attn_cache", "k")].placements == (Shard(2),
                                                           Shard(3))
    assert sh[("cache", "mamba", "ssm")].placements == (Replicate(),
                                                        Shard(3))
    old = state_shardings(state, cfg, make_partitioner(mesh), batch=1)
    assert old[("cache", "attn_cache", "k")].placements == (Replicate(),
                                                            Shard(3))
