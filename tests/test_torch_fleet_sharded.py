"""The port's sharded fleet dispatch (``repro_torch.fleet.sharded``) on the
CPU, against the JAX reference's ``repro.fleet.sharded``, and the two
control-plane example twins against the reference's examples.

The cases mirror ``tests/test_fleet_sharded.py`` and the sharded half of
``tests/test_obs.py``: one rank (a private gloo group of this process)
against the reference's 1-device mesh on the mixed-priority tenant fleet,
zero rebuilds through derates, contract changes and churn, four gloo ranks
(four processes over a ``FileStore``) against the reference's sharded run
on a forced 4-device CPU mesh (one JAX subprocess: the conftest keeps
``XLA_FLAGS`` out of this process), K = 2 domains on 4 ranks (two ranks
hold no lanes), and the flight recorder across shards.

Bars: allocations and grants within ``TOL`` (1e-6 W per device, the
reference's own sharded bar) of the reference's, with equal per-lane
iterations on every step without tenants.  With tenants the LPs are
eps-degenerate: on these fleets the port's stacked mode already parts from
the reference's by 300 Phase II iterations on one cold lane (ROADMAP
Queue 3), so the sharded lanes are held to the port's stacked iterations
on every step and to the reference's on the cold step's other lanes.
Every rank's result and grants are equal bit for bit; a step makes one
all-reduce and one all-gather.
Every group times out after 60 s and every process is joined with a
timeout, so a hung collective fails the test.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.nvpax import NvpaxOptions as JNvpaxOptions  # noqa: E402
from repro.core.pdhg import SolverOptions as JSolverOptions  # noqa: E402
from repro.fleet import FleetOrchestrator as JFleetOrchestrator  # noqa: E402
from repro.pdn.hierarchy_gen import homogeneous_fleet as j_homogeneous_fleet  # noqa: E402
from repro.pdn.tenants import TenantLayout as JTenantLayout  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.fleet import FleetLifecycle, FleetOrchestrator  # noqa: E402
from repro_torch.fleet import sharded as shd  # noqa: E402
from repro_torch.obs import recorder  # noqa: E402
from repro_torch.pdn.hierarchy_gen import homogeneous_fleet  # noqa: E402
from repro_torch.pdn.tenants import TenantLayout  # noqa: E402

TOL = 1e-6  # watts per device: the reference's sharded bar
RANKS = 4
JOIN_S = 240  # a rank or the reference subprocess past this fails the test
ROOT = Path(__file__).resolve().parent.parent
OPTS = NvpaxOptions(solver=SolverOptions(eps_abs=1e-11, eps_rel=1e-11, max_iters=20_000))
J_OPTS = JNvpaxOptions(solver=JSolverOptions(eps_abs=1e-11, eps_rel=1e-11, max_iters=20_000))


def _mixed_layout(pdn, cls, lo_frac=0.35, hi_frac=0.55):
    """``tests/test_fleet_sharded.py``'s layout: one cross-cut tenant
    (domains 0 and 1) and one domain-local tenant, the tenant devices at
    priority 2."""
    tenant_of = np.full(pdn.n, -1, np.int32)
    tenant_of[[0, 1, 16, 17]] = 0
    tenant_of[[4, 5, 6]] = 1
    b_min = np.zeros(2)
    b_max = np.zeros(2)
    for t in range(2):
        umax = pdn.dev_u[tenant_of == t].sum()
        b_min[t], b_max[t] = lo_frac * umax, hi_frac * umax
    priority = np.where(tenant_of >= 0, 2, 1).astype(np.int32)
    return cls(tenant_of, 2, b_min, b_max, priority)


def _sharded_step(orch, tele):
    """One step, with the collectives it made."""
    shd.COLLECTIVES.clear()
    res = orch.step(tele)
    assert dict(shd.COLLECTIVES) == {"all_reduce": 1, "all_gather": 1}
    return res


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------


def test_one_rank_matches_reference_and_stacked():
    """The mixed-priority tenant fleet, a cold and a warm step: the port
    at one gloo rank against the reference's sharded mode on its 1-device
    mesh and against the port's stacked mode."""
    jpdn = j_homogeneous_fleet(2, domain_oversub=1.15, root_oversub=1.0)
    pdn = homogeneous_fleet(2, domain_oversub=1.15, root_oversub=1.0)
    jlay, lay = _mixed_layout(jpdn, JTenantLayout), _mixed_layout(pdn, TenantLayout)
    jorch = JFleetOrchestrator(jpdn, level=1, tenants=jlay, mode="sharded", options=J_OPTS)
    orch = FleetOrchestrator(pdn, level=1, tenants=lay, mode="sharded", options=OPTS,
                             device="cpu")
    stacked = FleetOrchestrator(pdn, level=1, tenants=lay, mode="stacked", options=OPTS,
                                device="cpu")
    assert orch._shard.backend == "gloo" and (orch._shard.world, orch._shard.shards) == (1, 1)
    rng = np.random.default_rng(21)
    for t in range(2):
        tele = rng.uniform(400, 690, pdn.n)
        res, jres, sres = _sharded_step(orch, tele), jorch.step(tele), stacked.step(tele)
        assert res.stats["mode"] == "sharded" and res.stats["phase_iterations"].shape == (2, 3)
        for want in (jres, sres):
            np.testing.assert_allclose(res.allocation, want.allocation, rtol=0, atol=TOL)
            np.testing.assert_allclose(res.grants, np.asarray(want.grants), rtol=0, atol=TOL)
            np.testing.assert_allclose(res.demand, np.asarray(want.demand), rtol=0, atol=TOL)
            for key in ("slice_lo", "slice_hi"):
                np.testing.assert_allclose(res.stats[key], np.asarray(want.stats[key]), rtol=0,
                                           atol=TOL)
        for key in ("phase_iterations", "converged"):
            np.testing.assert_array_equal(res.stats[key], sres.stats[key])
        if t == 0:
            # the cold step's iterations, on the lanes where the reference
            # converged: its lane 1 runs Phase II to the 20,000 cap here
            # (KKT residual 1.5e-2, ROADMAP Queue 3) where the port converges
            # in 5,950, both within 2e-13 W
            conv = np.asarray(jres.stats["converged"])
            np.testing.assert_array_equal(res.stats["phase_iterations"][conv],
                                          np.asarray(jres.stats["phase_iterations"])[conv])
        for k in range(lay.n_tenants):
            s = res.allocation[lay.tenant_of == k].sum()
            assert lay.b_min[k] - 1e-4 <= s <= lay.b_max[k] + 1e-4
    assert orch.rebuild_count() == 1


def test_churn_and_grants_zero_rebuilds():
    """The twin of the reference's zero-retrace test: derates, tenant
    contract changes and leave/rejoin rebuild nothing, and the tenant
    minimums hold throughout."""
    pdn = homogeneous_fleet(2, domain_oversub=1.15, root_oversub=1.0)
    lay = _mixed_layout(pdn, TenantLayout, lo_frac=0.4)
    orch = FleetOrchestrator(pdn, level=1, tenants=lay, mode="sharded", options=OPTS,
                             device="cpu")
    life = FleetLifecycle(orch)
    tele = np.random.default_rng(22).uniform(500, 690, pdn.n)
    orch.step(tele)
    orch.step(tele)
    rebuilds = orch.rebuild_count()
    orch.set_domain_supply(0, 0.8)
    res = _sharded_step(orch, tele)
    assert res.allocation[lay.tenant_of == 0].sum() >= lay.b_min[0] - 1e-4
    orch.set_tenant_bounds(0, b_min=0.5 * 2800.0, b_max=0.52 * 2800.0)
    res = _sharded_step(orch, tele)
    s = res.allocation[lay.tenant_of == 0].sum()
    assert 0.5 * 2800.0 - 1e-4 <= s <= 0.52 * 2800.0 + 1e-4
    orch.set_tenant_bounds(0, b_min=lay.b_min[0], b_max=lay.b_max[0])
    life.device_leave([1, 17])
    res = _sharded_step(orch, tele)
    np.testing.assert_allclose(res.allocation[[1, 17]], 0.0)
    assert res.allocation[lay.tenant_of == 0].sum() >= lay.b_min[0] - 1e-4
    life.device_join([1, 17])
    res = _sharded_step(orch, tele)
    assert res.allocation[lay.tenant_of == 0].sum() >= lay.b_min[0] - 1e-4
    assert orch.rebuild_count() == rebuilds == 1


def test_flight_recorder_matches_stacked():
    """The twin of the reference's sharded flight test at one rank:
    sharded and stacked lanes have equal integer fields and ``alloc_W``
    within 1e-6 W; the flush is one gather."""
    pdn = homogeneous_fleet(4)
    rng = np.random.default_rng(11)
    tele = [rng.uniform(100.0, 700.0, pdn.n) for _ in range(3)]
    flights = {}
    for mode in ("stacked", "sharded"):
        orch = FleetOrchestrator(pdn, level=1, mode=mode, recorder=True, device="cpu")
        for p in tele:
            orch.step(p)
        shd.COLLECTIVES.clear()
        flights[mode] = orch.flush_recorder()
        assert flights[mode]["mode"] == mode
    assert dict(shd.COLLECTIVES) == {"flush_gather": 1}
    _assert_flights(flights["sharded"]["lanes"], flights["stacked"]["lanes"])


def _assert_flights(got, want):
    assert len(got) == len(want) > 0
    i_alloc = recorder.FIELDS.index("alloc_W")
    ints = [recorder.FIELDS.index(f) for f in ("tier", "iterations", "skipped", "converged")]
    for g, w in zip(got, want):
        g, w = np.asarray(g["rows"] if isinstance(g, dict) else g), np.asarray(w["rows"])
        assert g.shape == w.shape
        np.testing.assert_allclose(g[:, i_alloc], w[:, i_alloc], rtol=0, atol=TOL)
        np.testing.assert_array_equal(g[:, ints], w[:, ints])


# ---------------------------------------------------------------------------
# four gloo ranks against the reference's forced 4-device mesh
# ---------------------------------------------------------------------------

# the fleets of the multi-rank cases, built by either package ({pkg})
_CASES = """
import numpy as np
from {pkg}.pdn.hierarchy_gen import homogeneous_fleet
from {pkg}.pdn.tenants import TenantLayout


def layout(pdn, groups):
    tenant_of = np.full(pdn.n, -1, np.int32)
    for t, devs in enumerate(groups):
        tenant_of[devs] = t
    umax = np.array([pdn.dev_u[tenant_of == t].sum() for t in range(len(groups))])
    priority = np.where(tenant_of >= 0, 2, 1).astype(np.int32)
    return TenantLayout(tenant_of, len(groups), 0.35 * umax, 0.55 * umax, priority)


def cases():
    small = dict(racks_per_domain=1, servers_per_rack=2, gpus_per_server=4, domain_oversub=0.9)
    eight = homogeneous_fleet(8, root_oversub=1.0, **small)
    four = homogeneous_fleet(4, domain_oversub=1.15, root_oversub=0.9)
    two = homogeneous_fleet(2, root_oversub=0.9, **small)
    # tenant 0 spans all four domains, 1 is local, 2 spans domains 2 and 3
    ten = layout(four, [[0, 1, 16, 17, 32, 33, 48, 49], [4, 5, 6], [36, 37, 52]])
    rng = np.random.default_rng(7)
    return {{
        "eight": (eight, None, [rng.uniform(300, 690, eight.n) for _ in range(2)]),
        "tenants": (four, ten, [rng.uniform(400, 690, four.n) for _ in range(2)]),
        "two": (two, None, [rng.uniform(300, 690, two.n) for _ in range(2)]),
    }}
"""

_RANK_SCRIPT = """
import datetime
import sys

import numpy as np
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from repro_torch.core.nvpax import NvpaxOptions
from repro_torch.core.solver import SolverOptions
from repro_torch.fleet import FleetOrchestrator
from repro_torch.fleet import sharded as shd
""" + _CASES.format(pkg="repro_torch") + """
tight = NvpaxOptions(solver=SolverOptions(eps_abs=1e-11, eps_rel=1e-11, max_iters=20_000))
res = {}
for name, (pdn, lay, teles) in cases().items():
    orch = FleetOrchestrator(pdn, level=1, mode="sharded", tenants=lay, device="cpu",
                             options=tight if lay is not None else NvpaxOptions(),
                             recorder=name == "eight")
    lo = orch._shard
    res[name + "/layout"] = [lo.world, lo.shards, lo.lo, lo.hi]
    for t, tele in enumerate(teles):
        shd.COLLECTIVES.clear()
        r = orch.step(tele)
        key = f"{name}/{t}/"
        res[key + "coll"] = [shd.COLLECTIVES["all_reduce"], shd.COLLECTIVES["all_gather"]]
        res[key + "alloc"] = r.allocation
        res[key + "grants"] = r.grants
        res[key + "iters"] = r.stats["phase_iterations"]
        if lay is not None:
            res[key + "slice_hi"] = r.stats["slice_hi"]
    if orch.recorder_config is not None:
        shd.COLLECTIVES.clear()
        res[name + "/flight"] = np.stack([lane["rows"] for lane in orch.flush_recorder()["lanes"]])
        res[name + "/flush_coll"] = [shd.COLLECTIVES["flush_gather"]]
if rank == 0:  # the stacked program the sharded lanes are, on the tenant fleet
    pdn, lay, teles = cases()["tenants"]
    stacked = FleetOrchestrator(pdn, level=1, mode="stacked", tenants=lay, device="cpu",
                                options=tight)
    for t, tele in enumerate(teles):
        res[f"tenants/{t}/stacked_iters"] = stacked.step(tele).stats["phase_iterations"]
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""

_REF_SCRIPT = """
import sys

import numpy as np
from repro.core.nvpax import NvpaxOptions
from repro.core.pdhg import SolverOptions
from repro.fleet import FleetOrchestrator
from repro.fleet import sharded as sharded_mod
""" + _CASES.format(pkg="repro") + """
tight = NvpaxOptions(solver=SolverOptions(eps_abs=1e-11, eps_rel=1e-11, max_iters=20_000))
res = {}
for name, (pdn, lay, teles) in cases().items():
    orch = FleetOrchestrator(pdn, level=1, mode="sharded", tenants=lay,
                             options=tight if lay is not None else NvpaxOptions())
    res[name + "/shards"] = [sharded_mod.shard_count(orch.k)]
    for t, tele in enumerate(teles):
        r = orch.step(tele)
        key = f"{name}/{t}/"
        res[key + "alloc"] = r.allocation
        res[key + "grants"] = np.asarray(r.grants)
        res[key + "iters"] = np.asarray(r.stats["phase_iterations"])
        if lay is not None:
            res[key + "slice_hi"] = np.asarray(r.stats["slice_hi"])
np.savez(sys.argv[1], **res)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def _join(procs):
    """Wait for every process (killing all past ``JOIN_S``); each must exit 0."""
    errors = []
    for name, p in procs:
        try:
            _, err = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            pytest.fail(f"{name} did not finish in {JOIN_S} s (a hung collective?)")
        if p.returncode != 0:
            errors.append(f"{name} exited {p.returncode}: {err[-2000:]}")
    assert not errors, "\n".join(errors)


@pytest.fixture(scope="module", autouse=True)
def _four_rank_procs(tmp_path_factory):
    """Four gloo ranks of the port and the reference on a forced 4-device
    mesh, five processes started with the module so that they run beside
    its in-process tests; :func:`four_ranks` joins them.  Whatever is left
    is killed when the module ends."""
    tmp = tmp_path_factory.mktemp("sharded")
    ref_out = tmp / "ref.npz"
    procs = [("reference", subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(ref_out)], env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))]
    for rank in range(RANKS):
        procs.append((f"rank {rank}", subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, str(rank), str(RANKS), str(tmp / "store"),
             str(tmp)], env=_env(OMP_NUM_THREADS="1"),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
    yield tmp, procs
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def four_ranks(_four_rank_procs):
    """(per-rank results, reference results) of the five processes."""
    tmp, procs = _four_rank_procs
    _join(procs)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]
    return ranks, dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("case,shards", [("eight", 4), ("tenants", 4), ("two", 2)])
def test_four_ranks_match_reference(four_ranks, case, shards):
    """``eight``: 8 domains, 2 per rank; ``tenants``: 4 domains, one per
    rank, with tenants whose slices sit on different ranks (their slice
    demand goes through the all-reduce); ``two``: K = 2 on 4 ranks, ranks
    2 and 3 hold no lanes and still return the result."""
    ranks, ref = four_ranks
    assert int(ref[f"{case}/shards"][0]) == shards
    k = {"eight": 8, "tenants": 4, "two": 2}[case]
    for r, got in enumerate(ranks):
        per = k // shards
        lo = r * per if r < shards else k
        np.testing.assert_array_equal(got[f"{case}/layout"],
                                      [RANKS, shards, lo, lo + per if r < shards else k])
    keys = ["alloc", "grants", "iters"] + (["slice_hi"] if case == "tenants" else [])
    for t in range(2):
        for key in keys:
            name = f"{case}/{t}/{key}"
            for got in ranks[1:]:  # every rank holds the same bits
                np.testing.assert_array_equal(got[name], ranks[0][name], err_msg=name)
            if key == "iters" and case == "tenants":
                np.testing.assert_array_equal(ranks[0][name], ranks[0][f"{case}/{t}/stacked_iters"],
                                              err_msg=name)
                if t == 0:  # the lanes where the port's stacked mode has the reference's
                    same = (ranks[0][f"{case}/0/stacked_iters"] == ref[name]).all(axis=1)
                    assert same.sum() == 3, same
                    np.testing.assert_array_equal(ranks[0][name][same], ref[name][same])
            elif key == "iters":
                np.testing.assert_array_equal(ranks[0][name], ref[name], err_msg=name)
            else:
                np.testing.assert_allclose(ranks[0][name], ref[name], rtol=0, atol=TOL,
                                           err_msg=name)
        for got in ranks:
            np.testing.assert_array_equal(got[f"{case}/{t}/coll"], [1, 1])


def test_four_ranks_flight_matches_stacked(four_ranks):
    """The flight recorder across four ranks: the lanes meet only at the
    flush (one gather) and match the stacked fleet's own flight."""
    ranks, _ = four_ranks
    pdn = homogeneous_fleet(8, racks_per_domain=1, servers_per_rack=2, gpus_per_server=4,
                            domain_oversub=0.9, root_oversub=1.0)
    rng = np.random.default_rng(7)
    teles = [rng.uniform(300, 690, pdn.n) for _ in range(2)]
    stacked = FleetOrchestrator(pdn, level=1, mode="stacked", recorder=True, device="cpu")
    for tele in teles:
        stacked.step(tele)
    want = stacked.flush_recorder()["lanes"]
    for got in ranks:
        assert int(got["eight/flush_coll"][0]) == 1
        np.testing.assert_array_equal(got["eight/flight"], ranks[0]["eight/flight"])
        _assert_flights(list(got["eight/flight"]), want)


# ---------------------------------------------------------------------------
# the example twins against the reference's examples
# ---------------------------------------------------------------------------


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text: str) -> list[str]:
    """The printed lines, without the ones that state a wall time."""
    return [ln for ln in text.splitlines() if " ms" not in ln]


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("datacenter_simulation", ["--devices", "96", "--steps", "2"]),
])
def test_example_twins_print_the_reference_numbers(name, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _load(ROOT / "examples" / f"{name}.py").main()
    want = capsys.readouterr().out
    _load(ROOT / "examples" / f"torch_{name}.py").main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert len(_lines(got)) >= 5
    if name == "datacenter_simulation":
        # the paper's figures stay labelled as the paper's
        assert "(paper: 264.69 ms on an M4 Pro)" in got
