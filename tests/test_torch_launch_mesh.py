"""The port's training launcher at ``--mesh DxM`` past 1x1
(``repro_torch.launch.train``, ``repro_torch.sharding``) on four gloo ranks of
the CPU, against its own ``--mesh 1x1`` run and the JAX reference's parts.

Four gloo ranks (four processes over one ``FileStore``, started with the
module) run every mesh case in one start,
each a ``launch.train.run`` that joins their world: reduced qwen3-4b,
olmoe-1b-7b, mamba2-1.3b and whisper-tiny at ``--mesh 2x2``; qwen3-4b at
``1x4``, whose two kv heads do not divide the model axis of 4 (the resolver
replicates them, so each rank gathers its query heads); qwen3-4b at 2x2 with
``--compress-grads --power-managed``; and the drill's first half, ``--mesh
2x2 --ckpt-every 2 --fail-at 2``.  Every run starts from the reference's
weights (``init_train_state`` at key 0, carried across by ``convert``), so
the port's 1x1 runs and the reference's parts called as its ``main`` calls
them (``jax.jit(make_train_step(...))`` on ``SyntheticLMData`` batches) run
the same model.  The drill's second half restores the 2x2 checkpoint at
``1x1`` in this process and at ``1x2`` on two ranks the launcher spawns
itself.

Bars: each step's loss within 1e-5 relative of the 1x1 run's and of the
reference's (the launcher's bar, ``tests/test_torch_launch_train.py``).
After the last step every weight and AdamW moment within 1.2e-4 of the 1x1
run's in relative Frobenius norm, and element-wise within 1.5e-3 of the
leaf's largest magnitude; each weight placed as ``resolve_spec`` places it;
every rank holding the same gathered state (the replicas of a weight
agree).  The restored checkpoints give the saved bits.  The weights' bars
come from the 1x1 run's own noise (``tools/launch_ulp_spread.py --device
cpu --weights`` on these cases' weights and steps, one torch thread): a
1-ulp change of the embedding moves the 1x1 run's weights and moments by up
to 5.9e-4 of a leaf's largest magnitude (AdamW's m / sqrt(v) turns an
element's gradient near zero into a step of up to the learning rate,
whatever its size) and qwen3-4b's by 1.59e-5 in Frobenius norm with the
host's default GEMM path, 3.63e-5 with ``MKL_CBWR=COMPATIBLE
ATEN_CPU_CAPABILITY=default``; the Frobenius bar is 3.3 times the larger
(the multiple first taken over 5.9e-6, a spread measured from other
weights).  The 2x2 path itself is exact: run in float64 throughout, qwen3's
2x2 state lies 3.5e-15 from its 1x1 run's after three steps, so its gap in
float32 (4.13e-5 and 2.83e-5 on those two paths) is rounding that AdamW
amplifies.  A gradient reduced over the wrong ranks moves the norm by a
percent (a MoE weight's gradient taken as whole where it was each rank's
part gave 6.014 for 6.059).  The group times out after 300 s and
every process is joined with a timeout, so a hung collective fails the
test.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JSyntheticLMData  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import encdec_params_from_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.sharding import default_rules, param_sharding  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402

RANKS = 4
JOIN_S = 300
TOL = 1e-5  # relative, on each step's loss
PARAM_TOL = 1.2e-4  # each weight and moment's gap to the 1x1 run's, relative Frobenius norm
ELEM_TOL = 1.5e-3  # element-wise, of the 1x1 leaf's largest magnitude
BATCH, SEQ, LR, WARMUP = 4, 128, 3e-3, 10
ROOT = Path(__file__).resolve().parent.parent

# (case, arch, mesh, steps, extra flags)
CASES = [
    ("qwen3", "qwen3-4b", "2x2", 3, []),
    ("olmoe", "olmoe-1b-7b", "2x2", 3, []),
    ("mamba2", "mamba2-1.3b", "2x2", 3, []),
    ("whisper", "whisper-tiny", "2x2", 3, []),
    ("qwen3_1x4", "qwen3-4b", "1x4", 2, []),
    ("qwen3_flags", "qwen3-4b", "2x2", 2, ["--compress-grads", "--power-managed"]),
]
DRILL_STEPS, DRILL_AT = 4, 2
ARCHS = sorted({arch for _, arch, *_ in CASES})

_RANK_SCRIPT = """
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=300))
from repro_torch.configs import get_arch
from repro_torch.convert import encdec_params_from_numpy, lm_params_from_numpy
from repro_torch.launch import train

# the staged collectives (a card's path) called on CPU tensors: the ops' bits;
# the kernels registered for a card's tensors, on a group that takes them as
# they are (here CPU tensors on gloo): the ops' own, uncounted
from repro_torch.sharding import hoststaged
import torch.distributed._functional_collectives  # noqa: F401
ops, name = torch.ops._c10d_functional, dist.group.WORLD.group_name
x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1) + 0.5
calls = {
    "all_reduce": (x, "sum", name),
    "all_gather_into_tensor": (x, world, name),
    "reduce_scatter_tensor": (x, "sum", world, name),
    "all_to_all_single": (x, [1] * world, [1] * world, name),
}
same = {}
for op, args in calls.items():
    want = ops.wait_tensor(getattr(ops, op)(*[a.clone() if torch.is_tensor(a) else a
                                              for a in args]))
    same[op] = bool(torch.equal(hoststaged.staged(op)(*args), want))
    same[op + "/own"] = bool(torch.equal(ops.wait_tensor(hoststaged.kernel(op)(*args)), want))
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("m",))
d = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
want = d.redistribute(mesh, [Shard(1)]).to_local()
same["shard_dim_alltoall"] = bool(torch.equal(
    hoststaged.staged("shard_dim_alltoall")(x, 0, 1, mesh.get_group(0).group_name), want))
y = torch.arange(32, dtype=torch.float32).reshape(4, 8) * (rank + 1)  # the op's own: even shards
want = DTensor.from_local(y, mesh, [Shard(0)], run_check=False).redistribute(
    mesh, [Shard(1)]).to_local()
same["shard_dim_alltoall/own"] = bool(torch.equal(
    hoststaged.kernel("shard_dim_alltoall")(y, 0, 1, mesh.get_group(0).group_name), want))
same["counted"] = hoststaged.collective_counts()
open(f"{out}/staged.rank{rank}.json", "w").write(json.dumps(same))

spec = json.loads(open(out + "/cases.json").read())
real_build = train.build


def nested(flat):
    tree = {}
    for key, value in flat.items():
        *path, name = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = value
    return tree


def reference_weights(cfg):
    with np.load(f"{out}/weights_{cfg.name.removesuffix('-smoke')}.npz") as z:
        tree = nested({k: z[k] for k in z.files})
    from_numpy = encdec_params_from_numpy if cfg.is_encdec else lm_params_from_numpy
    api = real_build(cfg)
    return api._replace(init=lambda generator, device=None: from_numpy(tree, cfg, "cpu"))


train.build = reference_weights
for name, argv in spec["cases"]:
    try:
        r = train.run(train.parse_args(argv))
    except SystemExit as e:
        if rank == 0:
            open(f"{out}/{name}.json", "w").write(json.dumps({"exit": e.code}))
        continue
    state = r.state
    flat = {f"params/{k}": v.detach().numpy() for k, v in state.params.named_parameters()}
    flat.update({f"m/{k}": v.detach().numpy() for k, v in state.opt.m.named_parameters()})
    flat.update({f"v/{k}": v.detach().numpy() for k, v in state.opt.v.named_parameters()})
    digest = float(sum(np.abs(a).astype(np.float64).sum() * (i + 1)
                       for i, a in enumerate(flat.values())))
    rep = r.mesh_report
    if rank == 0:
        np.savez(f"{out}/{name}.npz", **flat)
        open(f"{out}/{name}.json", "w").write(json.dumps({
            "losses": r.losses, "slowdowns": r.slowdowns, "step": state.step,
            "placements": rep["placements"], "mesh": rep["mesh"],
            "ranks": rep["ranks"], "collectives": rep["collectives"]}, default=str))
    open(f"{out}/{name}.rank{rank}.digest", "w").write(repr(digest))
dist.destroy_process_group()
"""


def _flat_tree(tree, prefix=""):
    """A nested dict of numpy arrays as ``{"a/b/c": array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _argv(arch, mesh, steps, extra=()):
    return ["--arch", arch, "--reduced", "--steps", str(steps), "--batch", str(BATCH),
            "--seq", str(SEQ), "--mesh", mesh, "--device", "cpu", "--log-every", "1",
            *extra]


def _ref_weights(arch):
    cfg = jconfigs.get_arch(arch).reduced()
    params = jstep.init_train_state(cfg, jmodels.build(cfg), jax.random.key(0))[0].params
    return jax.tree.map(np.asarray, params)


def _ref_losses(arch, steps, weights):
    """The reference's parts as its launcher's ``main`` calls them."""
    cfg = jconfigs.get_arch(arch).reduced()
    api = jmodels.build(cfg)
    state = jstep.init_train_state(cfg, api, jax.random.key(0))[0]
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(state.params),
                                                    jax.tree.leaves(weights)))
    data = JSyntheticLMData(cfg.vocab, seed=0)
    enc = (cfg.enc_frames, cfg.d_model) if cfg.is_encdec else None
    step_fn = jax.jit(jstep.make_train_step(cfg, api, lr=LR, warmup=WARMUP, total_steps=steps))
    losses = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch(i, BATCH, SEQ, enc=enc).items()}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return np.array(losses)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's weights written for the ranks; the four ranks started
    on every mesh case; meanwhile, in this process, the reference's losses
    and the port's 1x1 runs of the same cases (torch on one thread)."""
    out = tmp_path_factory.mktemp("mesh")
    weights = {arch: _ref_weights(arch) for arch in ARCHS}
    for arch, tree in weights.items():
        np.savez(out / f"weights_{arch}.npz", **_flat_tree(tree))
    drill_dir = out / "drill"
    cases = [(name, _argv(arch, mesh, steps, extra)) for name, arch, mesh, steps, extra in CASES]
    cases.append(("drill", _argv("qwen3-4b", "2x2", DRILL_STEPS) + [
        "--ckpt-dir", str(drill_dir), "--ckpt-every", "2", "--fail-at", str(DRILL_AT)]))
    (out / "cases.json").write_text(json.dumps({"cases": cases}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r), str(RANKS),
                               str(out / "store"), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {name: _ref_losses(arch, steps, weights[arch])
                for name, arch, mesh, steps, extra in CASES if not extra}
        ones = {}
        with pytest.MonkeyPatch.context() as mp:
            real = train.build

            def reference_build(cfg):
                tree = weights[cfg.name.removesuffix("-smoke")]
                from_numpy = encdec_params_from_numpy if cfg.is_encdec else lm_params_from_numpy
                return real(cfg)._replace(
                    init=lambda generator, device=None: from_numpy(tree, cfg, "cpu"))

            mp.setattr(train, "build", reference_build)
            for name, arch, mesh, steps, extra in CASES:
                ones[name] = train.run(train.parse_args(_argv(arch, "1x1", steps, extra)))
            ones["drill"] = train.run(train.parse_args(
                _argv("qwen3-4b", "1x1", DRILL_STEPS)
                + ["--ckpt-dir", str(out / "whole"), "--ckpt-every", "2"]))
    finally:
        torch.set_num_threads(threads)
        logs = []
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
            logs.append((r, p.returncode, log))
    for r, rc, log in logs:
        assert rc == 0, f"rank {r} exited {rc}:\n{log[-4000:]}"
    got = {}
    for name, *_ in CASES:
        got[name] = json.loads((out / f"{name}.json").read_text())
        with np.load(out / f"{name}.npz") as z:
            got[name]["state"] = {k: z[k] for k in z.files}
        got[name]["digests"] = [(out / f"{name}.rank{r}.digest").read_text()
                                for r in range(RANKS)]
    got["drill"] = json.loads((out / "drill.json").read_text())
    return types.SimpleNamespace(out=out, got=got, refs=refs, ones=ones, drill_dir=drill_dir)


def _rel(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.abs(want)


def _close(got, want, key) -> None:
    d = np.asarray(got, np.float64) - want
    fro = np.linalg.norm(d) / max(np.linalg.norm(want), 1e-30)
    elem = np.abs(d).max() / max(float(np.abs(want).max()), 1e-30)
    assert fro <= PARAM_TOL and elem <= ELEM_TOL, (key, fro, elem)


def _state(run) -> dict:
    s = run.state
    out = {f"params/{k}": v.detach().numpy() for k, v in s.params.named_parameters()}
    out.update({f"m/{k}": v.detach().numpy() for k, v in s.opt.m.named_parameters()})
    out.update({f"v/{k}": v.detach().numpy() for k, v in s.opt.v.named_parameters()})
    return out


def _expected_placements(arch, mesh):
    d, m = (int(x) for x in mesh.split("x"))
    stand_in = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(d, m))
    cfg = configs.get_arch(arch).reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    return param_sharding(api.specs(), params, default_rules(stand_in)), params


def _walk(a, b):
    if isinstance(a, dict):
        for k in a:
            yield from _walk(a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b, strict=True):
            yield from _walk(x, y)
    else:
        yield a, b


@pytest.mark.parametrize("case", [c for c in CASES if not c[4]], ids=lambda c: c[0])
def test_mesh_run_matches_1x1_and_the_reference(world, case):
    """Each step's loss within TOL of the port's 1x1 run and of the
    reference's parts; every weight and moment of the last step within the
    weights' bars of the 1x1 run's; every weight
    placed by ``resolve_spec``; every rank the same gathered state; each
    rank holding its own shards."""
    name, arch, mesh, steps, _ = case
    got, one, ref = world.got[name], world.ones[name], world.refs[name]
    assert got["mesh"] == dict(zip(("data", "model"), (int(x) for x in mesh.split("x"))))
    assert len(got["losses"]) == steps and got["step"] == steps
    assert _rel(got["losses"], one.losses).max() <= TOL, (got["losses"], one.losses)
    assert _rel(got["losses"], ref).max() <= TOL, (got["losses"], ref)
    want = _state(one)
    assert got["state"].keys() == want.keys()
    for key, w in want.items():
        _close(got["state"][key], w, key)
    sh, params = _expected_placements(arch, mesh)
    seen = 0
    for s, placed in _walk(sh, got["placements"]):
        assert [str(p) for p in s.placements] == [str(p) for p in placed], (name, s, placed)
        seen += 1
    assert seen == sum(1 for _ in params.parameters())
    assert len(set(got["digests"])) == 1, got["digests"]
    full = sum(p.numel() * 4 * 3 for p in params.parameters())
    assert all(r["shard_bytes"] < full for r in got["ranks"]), (got["ranks"], full)
    assert len(got["collectives"]) == steps  # a card's staged collectives; none on the CPU


def test_staged_collectives(world):
    """The collectives a card's tensors take through the host
    (``sharding.hoststaged``), called on each rank's CPU tensors: the bits of
    the functional collectives and of DTensor's shard-to-shard all-to-all,
    each call counted; the kernels ``install`` registers, on a group that
    takes the tensors as they are, the ops' own bits, uncounted."""
    for r in range(RANKS):
        same = json.loads((world.out / f"staged.rank{r}.json").read_text())
        counted = same.pop("counted")
        assert all(same.values()) and len(same) == 10, (r, same)
        assert {k: v["calls"] for k, v in counted.items()} == {
            "all_gather": 1, "all_reduce": 1, "all_to_all": 2, "reduce_scatter": 1}, counted


def test_mesh_run_with_compression_and_power_management(world):
    """``--compress-grads --power-managed`` at 2x2: the 1x1 run's losses
    within TOL (the int8 scale taken over each whole gradient) and its
    slowdowns, rank 0's controller broadcast to every rank."""
    got, one = world.got["qwen3_flags"], world.ones["qwen3_flags"]
    assert _rel(got["losses"], one.losses).max() <= TOL, (got["losses"], one.losses)
    assert got["slowdowns"] == one.slowdowns and all(s > 1.0 for s in one.slowdowns)
    assert len(set(got["digests"])) == 1


def test_elastic_restore(world):
    """A checkpoint written at 2x2 (the drill crashed at step 2, exit code
    42) holds the keys, shapes and dtypes of the 1x1 run's step 2 checkpoint
    and its values within the weights' bars; restored at 1x1 (here) and at 1x2 (two
    ranks the launcher spawns) every leaf is the saved bits; the resumed
    steps 2-3 meet TOL against the uninterrupted 1x1 run."""
    assert world.got["drill"] == {"exit": 42}
    saved = world.drill_dir / f"step_{DRILL_AT:08d}"
    whole = world.out / "whole" / f"step_{DRILL_AT:08d}"
    manifests = [json.loads((d / "manifest.json").read_text()) for d in (saved, whole)]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    with np.load(saved / "leaves.npz") as z, np.load(whole / "leaves.npz") as w:
        bits = {k: z[k] for k in z.files}
        for k in w.files:
            _close(bits[k], w[k], k)
    cfg = configs.get_arch("qwen3-4b").reduced()
    uninterrupted = world.ones["drill"].losses

    def restored_bits(state):
        leaves = checkpoint._flatten(state, cfg)
        return all(np.array_equal(leaves[k], bits[k]) for k in bits), leaves.keys() == bits.keys()

    base = _argv("qwen3-4b", "1x1", DRILL_STEPS) + ["--ckpt-dir", str(world.drill_dir),
                                                    "--resume", "--ckpt-every", "100"]
    one = train.run(train.parse_args(base))
    assert one.start_step == DRILL_AT
    assert _rel(one.losses, uninterrupted[DRILL_AT:]).max() <= TOL
    like = one.state
    assert restored_bits(checkpoint.restore(str(world.drill_dir), DRILL_AT, like, cfg=cfg)) == (
        True, True)
    two = _argv("qwen3-4b", "1x2", DRILL_STEPS) + ["--ckpt-dir", str(world.drill_dir),
                                                   "--resume", "--ckpt-every", "100"]
    zero = two.copy()
    zero[zero.index("--steps") + 1] = str(DRILL_AT)  # restored, no step taken
    restored = train.run(train.parse_args(zero))
    assert restored.start_step == DRILL_AT and restored.losses == []
    assert restored.mesh_report["mesh"] == {"data": 1, "model": 2}
    assert restored_bits(restored.state) == (True, True)
    resumed = train.run(train.parse_args(two))
    assert resumed.start_step == DRILL_AT
    assert _rel(resumed.losses, uninterrupted[DRILL_AT:]).max() <= TOL, (resumed.losses,
                                                                        uninterrupted)
