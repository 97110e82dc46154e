"""Port parity for ``parallel/planner``: the JAX package's planner and the
port's on the same tables, constraints, reservations and device profile
(the JAX package's TPU profile dicts passed to the port, with the JAX
topology's fixed 32 GB/s host link), over the cases of
``tests/test_planner.py`` and ``tests/test_plan_criteo1tb_v5p64.py``.

Both planners are plain Python on Python floats, so the bar is identity,
not a tolerance: the same plan (sharding type, kernel, ranks, column
shards, cache / dedup / hier fields), the same chosen options down to
every shard's geometry, rank and ``Perf``/``Storage`` floats, the same
per-rank totals, the same ``PlanAssumptions``, the same serialized plan
string and ``plan_inputs_hash``, and a plan saved by either package
loading in the other.  A case whose inputs admit no plan raises
``PlannerError`` with the same message in both.

Then the port's own H100 profile: its plans for the application's and
the bench's tables run through the port's ``DistributedModelParallel``
on the CPU, and a planner run from the repository root reads no
calibration file."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torchrec_tpu.datasets.criteo import (
    DEFAULT_CAT_NAMES as J_CAT_NAMES,
    MLPERF_DLRM_V2_MULTI_HOT,
    MLPERF_DLRM_V2_ROWS,
)
from torchrec_tpu.ir.serializer import deserialize_plan as j_deserialize
from torchrec_tpu.ir.serializer import serialize_plan as j_serialize
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.parallel.planner import planners as jplanners
from torchrec_tpu.parallel.planner import provider as jprovider
from torchrec_tpu.parallel.planner import storage_reservations as jres
from torchrec_tpu.parallel.planner import types as jtypes
from torchrec_tpu.parallel.types import EmbeddingComputeKernel as JKernel
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.ir.serializer import deserialize_plan, serialize_plan
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.planner import planners as tplanners
from torchrec_tpu_torch.parallel.planner import provider as tprovider
from torchrec_tpu_torch.parallel.planner import storage_reservations as tres
from torchrec_tpu_torch.parallel.planner import types as ttypes
from torchrec_tpu_torch.parallel.types import (
    EmbeddingComputeKernel,
    ShardingType,
    table_wise_plan,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HOST_GBPS = 32  # the JAX Topology's fixed host link, 32e9 B/s

# -- the cases ---------------------------------------------------------------
# tables: (name, rows, dim, features); constraints: {table: dict of
# ParameterConstraints fields, sharding types and kernels by value}


def _three():  # tests/test_planner.py::tables
    return [("big", 1 << 20, 64, ["b"]), ("wide", 1000, 512, ["w"]),
            ("small", 100, 16, ["s"])]


def _criteo_hot(extra=None):
    cons = {f"t_{n}": {"pooling_factor": float(h)}
            for n, h in zip(J_CAT_NAMES, MLPERF_DLRM_V2_MULTI_HOT)}
    for name, c in (extra or {}).items():
        cons[name] = c
    return cons


def _criteo_tables():
    return [(f"t_{n}", r, 128, [n])
            for n, r in zip(J_CAT_NAMES, MLPERF_DLRM_V2_ROWS)]


def _criteo_rw_cw():
    extra = {}
    for n, rows in zip(J_CAT_NAMES, MLPERF_DLRM_V2_ROWS):
        hot = float(MLPERF_DLRM_V2_MULTI_HOT[J_CAT_NAMES.index(n)])
        if rows >= 4_000_000:
            extra[f"t_{n}"] = {"sharding_types": ["row_wise"],
                               "pooling_factor": hot}
        elif rows >= 100_000:
            extra[f"t_{n}"] = {"sharding_types": ["column_wise"],
                               "min_partition": 32, "pooling_factor": hot}
    return _criteo_hot(extra)


def _cached(clf=0.05):
    return {"big": {"sharding_types": ["table_wise"],
                    "cache_load_factor": clf}}


_SKEWED = [("hot", 1 << 21, 128, ["h"])] + [
    (f"cold{i}", 2000, 32, [f"c{i}"]) for i in range(6)]
_SKEWED_CONS = {"hot": {"pooling_factor": 50.0},
                **{f"cold{i}": {"pooling_factor": 1.0} for i in range(6)}}
_TIGHT = {"percentage": 0.1, "dense_param_bytes": 4 * (1 << 30),
          "feature_caps": {"f": 256 * 64}, "batch_size_per_device": 256}

# name -> planner inputs (defaults: v5p, world from "world", batch 512)
CASES = {
    "three_w1": dict(world=1, tables=_three()),
    "three_w2": dict(world=2, tables=_three(), batch=64),
    "three_w4": dict(world=4, tables=_three()),
    "three_w8": dict(world=8, tables=_three(), batch=64),
    "three_v5e_w8": dict(world=8, tables=_three(), profile="v5e"),
    "constraints_w8": dict(world=8, tables=_three(), constraints={
        "big": {"sharding_types": ["row_wise"]},
        "wide": {"sharding_types": ["column_wise"], "min_partition": 128}}),
    "forced_types_w4": dict(world=4, tables=_three(), constraints={
        "big": {"sharding_types": ["table_wise", "data_parallel"]},
        "wide": {"sharding_types": ["column_wise", "row_wise"],
                 "min_partition": 64},
        "small": {"sharding_types": ["row_wise"]}}),
    "hot_tables_w8": dict(world=8, batch=1024, tables=[
        (f"t{i}", 1 << 22, 128, [f"f{i}"]) for i in range(4)]),
    "multi_slice_w8": dict(world=8, slice_size=4, tables=_three()),
    "reservation_loose": dict(
        world=8, profile="v5e", slice_size=4, reserved=0.0, batch=256,
        tables=[("big", 20_000_000, 128, ["f"])],
        constraints={"big": {"sharding_types": [
            "table_wise", "column_wise", "row_wise"]}}),
    "reservation_tight": dict(
        world=8, profile="v5e", slice_size=4, reserved=0.0, batch=256,
        tables=[("big", 20_000_000, 128, ["f"])],
        constraints={"big": {"sharding_types": [
            "table_wise", "column_wise", "row_wise"]}},
        reservation=("heuristical", _TIGHT)),
    "reservation_fixed_w2": dict(world=2, reserved=0.0, tables=_three(),
                                 reservation=("fixed", {"percentage": 0.3})),
    "reservation_impossible": dict(
        world=2, profile="v5e", reserved=0.0, tables=_three(),
        reservation=("heuristical", {"percentage": 0.1,
                                     "dense_param_bytes": 64 * (1 << 30)})),
    "double_reservation": dict(world=8, tables=_three(),
                               reservation=("fixed", {"percentage": 0.15})),
    "cached_fits_w2": dict(world=2, batch=64, constraints=_cached(),
                           tables=[("big", 50_000, 64, ["f"])]),
    "cached_scaleup_w2": dict(world=2, batch=64, profile="v5e",
                              hbm_cap=8 * 1024 * 1024, constraints=_cached(),
                              tables=[("big", 50_000, 64, ["f"])]),
    "cached_impossible": dict(world=2, tables=[("big", 50_000, 64, ["f"])],
                              constraints={"big": {
                                  "sharding_types": ["row_wise"],
                                  "compute_kernels": ["fused_host_cached"]}}),
    "tiered_auto_w2": dict(
        world=2, profile="v5e", hbm_cap=64 << 20, batch=64,
        tables=[("huge", 400_000, 64, ["h"]), ("small", 100, 16, ["s"])],
        constraints={"huge": {"tiered": "auto", "zipf_exponent": 1.1,
                              "pooling_factor": 4.0}}),
    "dedup_w4": dict(world=4, tables=_three(), constraints={
        "big": {"sharding_types": ["row_wise"], "dedup": "on",
                "duplication_factor": 2.5},
        "wide": {"dedup": "auto", "duplication_factor": 1.6}}),
    "skewed_w8": dict(world=8, batch=256, tables=_SKEWED,
                      constraints=_SKEWED_CONS),
    "hierarchical_w8": dict(world=8, slice_size=4, hierarchical=True,
                            tables=_three(), constraints={
                                "big": {"sharding_types": ["row_wise"]},
                                "wide": {"sharding_types": [
                                    "grid_shard", "column_wise"]}}),
    "twrw_grid_w8": dict(world=8, slice_size=4, tables=_three(),
                         constraints={
                             "big": {"sharding_types": ["table_row_wise"]},
                             "wide": {"sharding_types": ["grid_shard"]}}),
    "bucketed_w4": dict(world=4, bucketed=True, tables=_three(),
                        constraints={"big": {"padding_efficiency": 0.5}}),
    "bench_v5p_w4": dict(world=4, batch=4096, tables=[
        (f"t_cat_{i}", 100_000, 128, [f"cat_{i}"]) for i in range(26)]),
    "criteo_v5p64": dict(world=64, batch=1024, tables=_criteo_tables(),
                         constraints=_criteo_hot()),
    "criteo_rw_cw_v5p64": dict(world=64, batch=1024,
                               tables=_criteo_tables(),
                               constraints=_criteo_rw_cw()),
    "criteo_v5e_w2": dict(world=2, batch=1024, profile="v5e",
                          tables=_criteo_tables(), constraints=_criteo_hot()),
}


# -- building both packages' inputs ----------------------------------------


def _tables(cls, pooling, spec):
    return [cls(num_embeddings=r, embedding_dim=d, name=n, feature_names=f,
                pooling=pooling.SUM) for n, r, d, f in spec]


def _constraints(types_mod, st_cls, kernel_cls, spec):
    out = {}
    for name, fields in (spec or {}).items():
        kw = dict(fields)
        if "sharding_types" in kw:
            kw["sharding_types"] = [st_cls(v) for v in kw["sharding_types"]]
        if "compute_kernels" in kw:
            kw["compute_kernels"] = [kernel_cls(v)
                                     for v in kw["compute_kernels"]]
        out[name] = types_mod.ParameterConstraints(**kw)
    return out or None


def _reservation(mod, spec):
    if spec is None:
        return None
    kind, kw = spec
    cls = (mod.HeuristicalStorageReservation if kind == "heuristical"
           else mod.FixedPercentageStorageReservation)
    return cls(**kw)


def _jax_topology(case):
    return jtypes.Topology(
        world_size=case["world"],
        tpu_version=jtypes.TpuVersion(case.get("profile", "v5p")),
        slice_size=case.get("slice_size"),
        hbm_cap_per_chip=case.get("hbm_cap"),
        reserved_hbm_fraction=case.get("reserved", 0.15))


def _port_topology(case):
    name = case.get("profile", "v5p")
    profile = dict(jtypes.TPU_PROFILES[jtypes.TpuVersion(name)],
                   host_bw=JAX_HOST_GBPS)
    return ttypes.Topology(
        world_size=case["world"], device=name, profile=profile,
        slice_size=case.get("slice_size"),
        hbm_cap_per_device=case.get("hbm_cap"),
        reserved_hbm_fraction=case.get("reserved", 0.15))


def _run(side, case):
    """(planner, plan or the PlannerError's message, tables, topology,
    constraints, reservation) of one package."""
    if side == "jax":
        tables = _tables(JCfg, JPooling, case["tables"])
        cons = _constraints(jtypes, JST, JKernel, case.get("constraints"))
        res = _reservation(jres, case.get("reservation"))
        topo, mod, err = _jax_topology(case), jplanners, jtypes.PlannerError
    else:
        tables = _tables(EmbeddingBagConfig, PoolingType, case["tables"])
        cons = _constraints(ttypes, ShardingType, EmbeddingComputeKernel,
                            case.get("constraints"))
        res = _reservation(tres, case.get("reservation"))
        topo, mod, err = _port_topology(case), tplanners, ttypes.PlannerError
    planner = None
    try:
        planner = mod.EmbeddingShardingPlanner(
            topology=topo, batch_size_per_device=case.get("batch", 512),
            constraints=cons, storage_reservation=res,
            bucketed_inputs=case.get("bucketed", False),
            hierarchical=case.get("hierarchical", False))
        plan = planner.plan(tables)
    except err as e:
        plan = str(e)
    return planner, plan, tables, topo, cons, res


def _ps_fields(ps):
    spec = None if ps.sharding_spec is None else [
        (tuple(m.shard_offsets), tuple(m.shard_sizes), m.placement)
        for m in ps.sharding_spec]
    return (ps.sharding_type.value, ps.compute_kernel.value, ps.ranks,
            ps.num_col_shards, spec, ps.cache_load_factor, ps.dedup,
            ps.dedup_factor, ps.hier, ps.hier_factor)


def _option_fields(o):
    return (o.name, o.sharding_type.value, o.compute_kernel.value,
            o.num_embeddings, o.embedding_dim, o.cache_load_factor, o.dedup,
            o.duplication_factor, o.zipf_exponent,
            [(s.size, s.offset, s.rank, dataclasses.astuple(s.perf),
              dataclasses.astuple(s.storage)) for s in o.shards])


@pytest.mark.parametrize("name", sorted(CASES))
def test_planner_matches_jax(name, tmp_path):
    case = CASES[name]
    jp, jplan, jtables, jtopo, jcons, jr = _run("jax", case)
    tp, tplan, ttables, ttopo, tcons, tr = _run("torch", case)
    if isinstance(jplan, str) or isinstance(tplan, str):
        assert tplan == jplan  # both raised, with one message
        return
    assert list(tplan) == list(jplan)
    for t in jplan:
        assert _ps_fields(tplan[t]) == _ps_fields(jplan[t]), t
    assert ([_option_fields(o) for o in tp.last_options]
            == [_option_fields(o) for o in jp.last_options])
    assert ({r: dataclasses.astuple(p)
             for r, p in tp.stats.per_rank_perf.items()}
            == {r: dataclasses.astuple(p)
                for r, p in jp.stats.per_rank_perf.items()})
    assert tp.stats.per_rank_hbm == jp.stats.per_rank_hbm
    assert [dataclasses.astuple(d.storage) for d in ttopo.devices] == [
        dataclasses.astuple(d.storage) for d in jtopo.devices]
    assert tplan.assumptions.to_dict() == jplan.assumptions.to_dict()
    assert (tplan.assumptions.fingerprint()
            == jplan.assumptions.fingerprint())
    assert serialize_plan(tplan) == j_serialize(jplan)
    batch = case.get("batch", 512)
    assert (tprovider.plan_inputs_hash(ttables, ttopo, batch, tcons, tr)
            == jprovider.plan_inputs_hash(jtables, jtopo, batch, jcons, jr))
    # a plan saved by either package loads in the other
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tprovider.save_plan(tpath, tplan, ttables, ttopo, batch, tcons, tr)
    jprovider.save_plan(jpath, jplan, jtables, jtopo, batch, jcons, jr)
    from_jax = tprovider.load_plan(jpath, ttables, ttopo, batch, tcons, tr)
    from_port = jprovider.load_plan(tpath, jtables, jtopo, batch, jcons, jr)
    assert from_jax is not None and from_port is not None
    assert serialize_plan(from_jax) == j_serialize(from_port) == \
        j_serialize(jplan)
    assert tprovider.load_plan(jpath, ttables, ttopo, batch + 1, tcons,
                               tr) is None


def test_serialized_plan_round_trips_across_packages():
    """A hand-written plan with every field set crosses both ways."""
    case = CASES["dedup_w4"]
    _, jplan, *_ = _run("jax", case)
    for name, ps in jplan.items():
        ps.hier, ps.hier_factor, ps.dedup_factor = True, 1.5, 2.0
    text = j_serialize(jplan)
    assert serialize_plan(deserialize_plan(text)) == text
    assert j_serialize(j_deserialize(serialize_plan(
        deserialize_plan(text)))) == text


# -- the H100 profile -------------------------------------------------------


def _bench_tables(rows=100_000, n=26, dim=128):
    return tuple(EmbeddingBagConfig(num_embeddings=rows, embedding_dim=dim,
                                    name=f"t_cat_{i}",
                                    feature_names=[f"cat_{i}"])
                 for i in range(n))


def test_h100_profile_matches_jax_planner_fed_the_same_constants(
        monkeypatch):
    """The JAX planner, its v5p profile swapped for the H100's numbers
    (and its host link set to the H100's), plans the bench tables at
    world 4 as the port's default topology does."""
    h100 = ttypes.DEVICE_PROFILES[ttypes.DEFAULT_DEVICE]
    monkeypatch.setitem(jtypes.TPU_PROFILES, jtypes.TpuVersion.V5P,
                        {k: v for k, v in h100.items() if k != "host_bw"})
    jtopo = jtypes.Topology(world_size=4)
    jtopo.host_bw = h100["host_bw"] * 1e9
    jplan = jplanners.EmbeddingShardingPlanner(
        topology=jtopo, batch_size_per_device=4096).plan(
            _tables(JCfg, JPooling, [(c.name, c.num_embeddings, 128,
                                      c.feature_names)
                                     for c in _bench_tables()]))
    tplan = tplanners.EmbeddingShardingPlanner(
        world_size=4, batch_size_per_device=4096).plan(_bench_tables())
    assert serialize_plan(tplan) == j_serialize(jplan)
    assert tplan.assumptions.to_dict() == jplan.assumptions.to_dict()


def test_h100_planner_reads_no_calibration_file(monkeypatch):
    """From the repository root, beside the JAX package's TPU calibration
    file: every constant stays the H100 profile's ASSUMED value."""
    monkeypatch.chdir(ROOT)
    assert os.path.exists(os.path.join(ROOT, "PLANNER_CALIBRATION.json"))
    planner = tplanners.EmbeddingShardingPlanner(world_size=2)
    planner.plan(_bench_tables(n=2))
    topo = planner.topology
    assert set(topo.calibration_sources.values()) == {"ASSUMED"}
    assert topo.hbm_bw == 3350e9
    assert topo.load_calibration().hbm_bw == 3350e9
    assert set(topo.calibration_sources.values()) == {"ASSUMED"}
    assert not os.path.exists(ttypes.DEFAULT_CALIBRATION)
    assert "ASSUMED=dcn_bw,flops,hbm_bw,host_bw,ici_bw" in planner.last_report


def test_h100_plans_of_app_and_bench_tables_run_through_the_dmp():
    """The H100 profile's plans, made at the full table sizes: the bench
    tables at world 1 are ``table_wise_plan`` and at world 4 every table
    is row-wise; the application's tables at world 1 are table-wise.
    Each builds the port's sharded collection at its world, and the
    world-1 plans train two steps through the DMP on the CPU (tables cut
    to 1,000 rows; the plan is by name)."""
    bench = _bench_tables()
    plan1 = tplanners.EmbeddingShardingPlanner(
        world_size=1, batch_size_per_device=4096).plan(bench)
    assert serialize_plan(plan1) == serialize_plan(table_wise_plan(bench))
    plan4 = tplanners.EmbeddingShardingPlanner(
        world_size=4, batch_size_per_device=4096).plan(bench)
    assert {ps.sharding_type for ps in plan4.values()} == {
        ShardingType.ROW_WISE}
    ShardedEmbeddingBagCollection.build(
        bench, plan4, 4, 4096, {c.feature_names[0]: 4096 for c in bench})
    app = _bench_tables(n=8, dim=128)
    app_plan = tplanners.EmbeddingShardingPlanner(
        world_size=1, batch_size_per_device=4096).plan(app)
    assert {ps.sharding_type for ps in app_plan.values()} == {
        ShardingType.TABLE_WISE}
    for tables, plan, ids in ((bench, plan1, 1), (app, app_plan, 10)):
        small = _bench_tables(rows=1000, n=len(tables), dim=16)
        keys = [c.feature_names[0] for c in small]
        ds = RandomRecDataset(keys, 32, [1000] * len(keys),
                              [ids] * len(keys), num_dense=13)
        dmp = DistributedModelParallel(
            DLRM(EmbeddingBagCollection(small, device="meta"), 13, (32, 16),
                 (32, 1)),
            small, plan, 32, dict(zip(keys, ds.caps)),
            dense_optimizer=adagrad(0.05), device="cpu")
        state = dmp.init(torch.Generator().manual_seed(0))
        it = iter(ds)
        for _ in range(2):
            state, m = dmp.train_step(state, next(it))
            assert np.isfinite(float(m["loss"]))
            assert not m["id_overflow"].any()


def test_host_cached_plan_raises_in_the_dmp():
    """The planner prices host-cached options and the runtime takes them
    (tiered storage, ``tiered/``): a plan that picks one builds, its
    table a table-wise group over the rows it is given (the cache's);
    a host-cached table on a layout other than TW or DP with one column
    shard raises, since a write-back would persist partial rows."""
    case = CASES["cached_scaleup_w2"]
    _, plan, tables, *_ = _run("torch", case)
    assert plan["big"].compute_kernel == (
        EmbeddingComputeKernel.FUSED_HOST_CACHED)
    ebc = ShardedEmbeddingBagCollection.build(tables, plan, 2, 64,
                                              {"f": 64})
    weights = ebc.tables_to_weights(ebc.init_params(
        torch.Generator().manual_seed(0), rank=0))
    assert weights["big"].shape[0] == next(
        t.num_embeddings for t in tables if t.name == "big")
    rw = dict(plan)
    rw["big"] = dataclasses.replace(plan["big"],
                                    sharding_type=ShardingType.ROW_WISE,
                                    ranks=[0, 1])
    with pytest.raises(ValueError, match="TW or DP"):
        ShardedEmbeddingBagCollection.build(tables, rw, 2, 64, {"f": 64})
