"""The port's mesh (``parallel/mesh.py``) against the JAX package's on the
same specs: ``MeshSpec.parse`` and ``resolved``, ``dcn_factors``,
``validate_mesh_usage`` and ``batch_shard_count``, values and error
messages equal; then the port's rank layout: rank r at the coordinates of
the JAX mesh's device r (row-major over ``AXIS_ORDER``), its lines, and
the rows a rank holds. Pure Python on both sides: exact equality."""

import dataclasses

import numpy as np
import pytest

from distributed_pytorch_training_tpu.parallel import mesh as jmesh
from distributed_pytorch_training_tpu_torch.parallel import mesh as pmesh
from distributed_pytorch_training_tpu_torch.parallel.collectives import (
    AxisGroup, AxisLoop,
)

SPECS = ["data=4,model=2", "data=-1", "seq=2", "data=2,seq=4",
         "slice=2,data=2,seq=2", " data = 2 , fsdp=2 ,", "pipe=2,expert=2",
         "model=-1,data=2", ""]
BAD_SPECS = ["bogus=2", "data", "data=x", "data=0", "data=-2", "data=2=3"]


def raised(fn, *args):
    """(exception type name, message) of ``fn(*args)``, or None."""
    try:
        fn(*args)
    except Exception as e:          # the two sides must raise alike
        return type(e).__name__, str(e)
    return None


def test_axis_constants_equal_the_jax_package():
    assert pmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert pmesh.BATCH_AXES == jmesh.BATCH_AXES
    assert pmesh.AXIS_NAMES == jmesh.AXIS_NAMES


@pytest.mark.parametrize("text", SPECS)
def test_parse_equals_jax(text):
    ours, ref = pmesh.MeshSpec.parse(text), jmesh.MeshSpec.parse(text)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("text", BAD_SPECS)
def test_parse_errors_equal_jax(text):
    got = raised(pmesh.MeshSpec.parse, text)
    assert got is not None and got == raised(jmesh.MeshSpec.parse, text)


@pytest.mark.parametrize("kw,n", [
    (dict(data=4, model=2), 8), (dict(), 8), (dict(data=-1, seq=2), 8),
    (dict(data=2, seq=4), 8), (dict(slice=2, data=-1), 8),
    (dict(data=3), 8), (dict(data=-1, seq=3), 8), (dict(data=-1, model=-1),
                                                    8),
    (dict(data=0), 4), (dict(data=2, seq=2), 2), (dict(seq=2, data=1), 2)])
def test_resolved_equals_jax(kw, n):
    ours, ref = pmesh.MeshSpec(**kw), jmesh.MeshSpec(**kw)
    want = raised(ref.resolved, n)
    assert raised(ours.resolved, n) == want
    if want is None:
        assert ours.resolved(n) == ref.resolved(n)
        assert list(ours.resolved(n)) == list(ref.resolved(n))


@pytest.mark.parametrize("sizes,n_slices", [
    (dict(data=8), 2), (dict(slice=2, data=4), 2), (dict(data=2, pipe=2), 4),
    (dict(data=3, fsdp=2), 6), (dict(seq=4, data=1), 2),
    (dict(data=2, model=4), 4), ({"data": 4}, 1)])
def test_dcn_factors_equal_jax(sizes, n_slices):
    want = raised(jmesh.dcn_factors, sizes, n_slices)
    assert raised(pmesh.dcn_factors, sizes, n_slices) == want
    if want is None:
        assert pmesh.dcn_factors(sizes, n_slices) \
            == jmesh.dcn_factors(sizes, n_slices)


def both_meshes(devices, **kw):
    spec = jmesh.MeshSpec(**kw)
    n = int(np.prod([v for v in spec.resolved(8).values()]))
    jax_mesh = jmesh.build_mesh(spec, devices=devices[:n])
    return jax_mesh, pmesh.build_mesh(pmesh.MeshSpec(**kw), world=n, rank=0)


USAGE = [
    (dict(data=4, seq=2), dict(attention="xla")),
    (dict(data=4, seq=2), dict(attention="flash")),
    (dict(data=4, seq=2), dict(attention="ring")),
    (dict(data=2, seq=4), dict(attention="ulysses")),
    (dict(data=4, pipe=2), dict()),
    (dict(data=4, pipe=2), dict(pipelined=True)),
    (dict(data=4, expert=2), dict()),
    (dict(data=4, expert=2), dict(is_moe=True)),
    (dict(data=4, model=2), dict()),
    (dict(data=2, seq=2, pipe=2), dict(attention="auto")),
    (dict(data=4, fsdp=2), dict()),
    (dict(data=8), dict(attention="flash")),
]


@pytest.mark.parametrize("kw,usage", USAGE,
                         ids=[f"{k}-{u}" for k, u in USAGE])
def test_validate_mesh_usage_equals_jax(devices, kw, usage):
    jax_mesh, mesh = both_meshes(devices, **kw)
    got = raised(lambda: pmesh.validate_mesh_usage(mesh, **usage))
    assert got == raised(lambda: jmesh.validate_mesh_usage(jax_mesh,
                                                           **usage))
    assert pmesh.validate_mesh is pmesh.validate_mesh_usage


@pytest.mark.parametrize("kw", [dict(data=8), dict(data=4, seq=2),
                                dict(data=2, seq=4), dict(slice=2, data=4),
                                dict(slice=2, data=2, seq=2),
                                dict(data=2, fsdp=2, model=2)])
def test_batch_shard_count_and_layout_equal_jax(devices, kw):
    """Rank r sits where the JAX mesh puts device r (its device ids run
    row-major over the axes on the CPU mesh), and the batch count and
    each rank's batch coordinate agree with the JAX mesh's."""
    jax_mesh, mesh = both_meshes(devices, **kw)
    assert pmesh.batch_shard_count(mesh) == jmesh.batch_shard_count(
        jax_mesh)
    assert mesh.shape == dict(jax_mesh.shape) and mesh.size == jax_mesh.size
    ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    for r in range(mesh.size):
        where = tuple(int(i[0]) for i in np.nonzero(ids == devices[r].id))
        assert tuple(mesh.coords(r).values()) == where
        assert mesh.rank_of(mesh.coords(r)) == r
        # the batch coordinate: the row-major index over the batch axes
        c = mesh.coords(r)
        idx = 0
        for a in pmesh.BATCH_AXES:
            idx = idx * mesh.shape[a] + c[a]
        assert pmesh.Mesh(mesh.shape, r).batch_index == idx


def test_lines_partition_the_ranks():
    mesh = pmesh.build_mesh(pmesh.MeshSpec(data=2, seq=2), world=4, rank=3)
    assert mesh.coords() == dict(slice=0, pipe=0, data=1, fsdp=0, expert=0,
                                 seq=1, model=0)
    assert mesh.line(pmesh.SEQ) == [2, 3]
    assert mesh.line(pmesh.DATA) == [1, 3]
    assert mesh.line(pmesh.BATCH_AXES) == [1, 3]
    assert mesh.line((pmesh.DATA, pmesh.SEQ)) == [0, 1, 2, 3]
    assert mesh.lines(pmesh.SEQ) == [[0, 1], [2, 3]]
    assert mesh.axis_index(pmesh.SEQ) == 1 and mesh.batch_index == 1
    assert mesh.active() == {"data": 2, "seq": 2}
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh.line("sequence")


def test_axis_of_a_one_rank_line_is_a_loop_of_one():
    mesh = pmesh.build_mesh(pmesh.MeshSpec(data=-1), world=1, rank=0)
    axis = mesh.axis(pmesh.SEQ)
    assert isinstance(axis, AxisLoop) and axis.size == 1
    assert axis.index == (0,)
    # one process, no process group: the whole-world line is the default
    # group, a group of one
    assert isinstance(mesh.axis(pmesh.DATA), AxisLoop)
    assert mesh.group(pmesh.DATA) is None
    assert AxisGroup(None).size == 1


def test_every_rank_of_a_seq_line_holds_the_same_rows():
    """The rows follow the batch coordinate: data=2, seq=2 splits a global
    batch of 2 x per-device batch in two, and both seq ranks of a line
    hold the same half."""
    for r in range(4):
        mesh = pmesh.Mesh(pmesh.MeshSpec(data=2, seq=2).resolved(4), r)
        assert mesh.batch_index == r // 2
        assert pmesh.local_batch_size(8, mesh) == 8
    assert pmesh.batch_shard_count(mesh) == 2
