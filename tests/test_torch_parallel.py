"""The port's parallel/groupby.py and parallel/mesh.py against the JAX
package's: the FNV-1a tag buckets, the bucket histogram (torch.bincount,
summed over a process group; the JAX one sums a one-hot over the
conftest's virtual 8-device CPU mesh), the owner assignment, the routed
groups, and the data-parallel align step (dp_align on each device of a
list, here eight entries of the CPU; the JAX one on the virtual mesh).
Counts, owners, scores and ops are integers or dyadic floats: every
comparison is exact. The cases of tests/test_distributed_groupby.py and
tests/test_parallel.py::test_sharded_align_step_matches_single_device."""

import numpy as np
import pytest
import torch

from clique_tpu_torch.parallel import groupby as tg
from clique_tpu_torch.parallel import make_mesh, sharded_align_step

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _jax_mesh():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from clique_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(8)


def test_tag_bucket_matches_jax():
    from clique_tpu.parallel.groupby import tag_bucket

    rng = np.random.default_rng(1)
    for n in (1, 7, 64, 1024):
        for _ in range(20):
            tag = rng.integers(0, 256, int(rng.integers(0, 40))).astype(
                np.uint8).tobytes()
            assert tg.tag_bucket(tag, n) == tag_bucket(tag, n)


def test_bucket_histogram_psum():
    from clique_tpu.parallel.groupby import bucket_histogram

    buckets = np.array([0, 1, 1, 2, 2, 2, 3, 3] * 2, dtype=np.int32)
    got = tg.bucket_histogram(None, buckets, 4, device="cpu")
    assert got.tolist() == [2, 4, 6, 4]
    assert got.tolist() == bucket_histogram(_jax_mesh(), buckets,
                                            4).tolist()
    # a bucket past n_buckets would be a caller's bug; empty input is not
    assert tg.bucket_histogram(None, np.zeros(0, np.int32), 3,
                               device="cpu").tolist() == [0, 0, 0]


def test_owner_assignment_balanced_and_deterministic():
    from clique_tpu.parallel.groupby import assign_bucket_owners

    hist = np.array([100, 1, 1, 1, 50, 49], dtype=np.int64)
    owner = tg.assign_bucket_owners(hist, 2)
    assert (owner == tg.assign_bucket_owners(hist, 2)).all()
    assert owner.tolist() == assign_bucket_owners(hist, 2).tolist()
    load = [int(hist[owner == h].sum()) for h in (0, 1)]
    assert abs(load[0] - load[1]) <= 100  # roughly balanced


def test_groups_never_split_across_owners():
    from clique_tpu.parallel.groupby import (distributed_group_keys,
                                             exchange_by_owner)

    rng = np.random.default_rng(4)
    tags = [bytes(rng.choice(list(b"ACGT"), 12)) for _ in range(40)]
    # 4 hosts each observing overlapping tag multisets
    per_host = [list(rng.choice(len(tags), 30)) for _ in range(4)]
    per_host_keys = [[tags[i] for i in host] for host in per_host]
    hist, owner = tg.distributed_group_keys(None, per_host_keys,
                                            n_buckets=64, device="cpu")
    j_hist, j_owner = distributed_group_keys(_jax_mesh(), per_host_keys,
                                             n_buckets=64)
    assert hist.tolist() == j_hist.tolist()
    assert owner.tolist() == j_owner.tolist()
    assert int(hist.sum()) == sum(len(k) for k in per_host_keys)

    items = [[(h, i) for i, _k in enumerate(keys)]
             for h, keys in enumerate(per_host_keys)]
    routed = tg.exchange_by_owner(items, per_host_keys, owner, 64)
    assert routed == exchange_by_owner(items, per_host_keys, j_owner, 64)
    # every read with the same tag must land on the same host
    tag_to_host = {}
    for h, host_items in enumerate(routed):
        for (src_h, src_i) in host_items:
            key = per_host_keys[src_h][src_i]
            assert tag_to_host.setdefault(key, h) == h
    # nothing lost
    assert sum(len(r) for r in routed) == sum(len(k) for k in per_host_keys)


def test_psum_histogram_single_process():
    from clique_tpu_torch.parallel.distributed import (global_mesh,
                                                       psum_histogram)

    local = np.array([3, 0, 5, 1], dtype=np.int32)
    assert psum_histogram(global_mesh(), local).tolist() == [3, 0, 5, 1]
    assert tg.world_of(None) == 1


@pytest.mark.parametrize("n_devices,B", [(8, 16), (3, 10)],
                         ids=["8-devices", "3-devices-uneven"])
def test_sharded_align_step_matches_single_device(n_devices, B):
    """sharded_align_step over n CPU entries against the JAX
    sharded_align_step on the virtual 8-device mesh (B = 16, the JAX
    test's shape) or the JAX single-device align_batch_device (an uneven
    split the JAX mesh cannot take), and against one dp_align call."""
    from clique_tpu.align.batch import align_batch_device
    from clique_tpu.align.batch import scoring_to_params as jax_params
    from clique_tpu.align.scoring import AffineScoring as JaxAffine
    from clique_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from clique_tpu.parallel.mesh import sharded_align_step as jax_step
    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.scoring import AffineScoring

    rng = np.random.default_rng(0)
    LR, LD = 24, 32
    refs = rng.choice(BASES, size=(B, LR)).astype(np.uint8)
    reads = rng.choice(BASES, size=(B, LD)).astype(np.uint8)
    ref_lens = np.full(B, LR, dtype=np.int32)
    read_lens = np.full(B, LD, dtype=np.int32)
    read_lens[1::3] = LD - 5
    params = jax_params(JaxAffine.aligner_default())

    mesh = [torch.device("cpu")] * n_devices
    scores, ops, n_ops = sharded_align_step(
        mesh, refs, reads, ref_lens, read_lens, np.asarray(params),
        n1=LR + 1, n2=LD + 1)
    if B % 8 == 0:
        _jax_mesh()
        want = jax_step(jax_make_mesh(8), refs, reads, ref_lens, read_lens,
                        params, n1=LR + 1, n2=LD + 1)
    else:
        bw = np.maximum(ref_lens, read_lens)
        single, _ = align_batch_device(refs, reads, ref_lens, read_lens, bw,
                                       params, n1=LR + 1, n2=LD + 1)
        want = (single.score, single.ops, single.n_ops)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(n_ops.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(ops.numpy(), np.asarray(want[1]))

    t_params = tbatch.scoring_to_params(AffineScoring.aligner_default(),
                                        "cpu")
    fused, _ = dp_kernels.dp_align(
        *(torch.from_numpy(a) for a in (refs, reads, ref_lens, read_lens)),
        t_params, n1=LR + 1, n2=LD + 1, special_mode="both")
    _packed, one_n, one_score = tbatch.unfuse_result(fused.numpy())
    np.testing.assert_array_equal(scores.numpy(), one_score)
    np.testing.assert_array_equal(n_ops.numpy(), one_n)


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        make_mesh(1)
