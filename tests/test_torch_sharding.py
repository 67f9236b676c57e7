"""The port's logical sharding (``repro_torch.sharding``) and meshes
(``repro_torch.launch.mesh``) against the JAX reference's
``repro.sharding.logical`` and the models' spec trees, on the CPU.

The reference's ``tests/test_sharding_analysis.py`` does not collect under
the installed JAX (``AbstractMesh``'s signature changed), so its five
resolver cases are written out here against the port, with the specs they
expect.  The reference's ``resolve_spec`` reads only its mesh's
``axis_names`` and ``shape``, so it is called with a stand-in that has
those; the port's with a ``DeviceMesh`` of the production shape, laid out
on a ``"fake"`` process group of 256 or 512 ranks (torn down after each
test).  The reference's spec trees are captured through ``jax.eval_shape``
of its ``init`` (no weight is allocated), as its dry run does.
"""

from __future__ import annotations

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.sharding import logical as jlogical  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    P,
    constrain,
    default_rules,
    param_sharding,
    placements,
    resolve_spec,
    use_rules,
)

ARCHS = list_archs()
POD = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
MULTI = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))


def _ref_mesh(mesh):
    """The reference's view of a mesh: its axis names and sizes."""
    names = tuple(mesh.mesh_dim_names)
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, mesh.shape)))


@pytest.fixture
def fake_world():
    """A ``"fake"`` process group of the given world size, torn down after."""
    def start(world: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_resolver_cases():
    """The reference's five resolver cases, with the specs written out."""
    r = default_rules(MULTI)
    assert resolve_spec(("embed", "ff"), (4096, 14336), r) == P("data", "model")
    # whisper: 6 heads do not divide 16 -> replicated; batch takes ("pod", "data")
    assert resolve_spec(("batch", None, "q_heads", None), (256, 128, 6, 64), r) == P(
        ("pod", "data"), None, None, None)
    # grok: 8 experts do not divide 16 -> replicated, ff shards instead
    assert resolve_spec(("experts", "embed", "ff"), (8, 6144, 32768), r) == P(
        None, "data", "model")
    # olmoe: 64 experts divide 16; ff cannot reuse model
    assert resolve_spec(("experts", "embed", "ff"), (64, 2048, 1024), r) == P(
        "model", "data", None)
    # vocab takes model; heads_merged then cannot reuse it
    assert resolve_spec(("vocab", "heads_merged"), (151936, 4096), r) == P("model", None)
    pod = default_rules(POD)
    assert resolve_spec(("batch", "seq_shard", None, None), (1, 524288, 8, 128), pod) == P(
        None, ("data", "model"), None, None)
    serve = default_rules(POD, serving=True)
    assert resolve_spec(("embed", "heads_merged"), (4096, 4096), pod) == P("data", "model")
    assert resolve_spec(("embed", "heads_merged"), (4096, 4096), serve) == P(None, "model")
    assert P("data", None) == ("data", None) and P("data") != P("data", None)


def _ref_specs(name):
    """The reference's spec tree and parameter shapes at full size."""
    api = jbuild(jget_arch(name))
    box = {}

    def init(key):
        params, box["specs"] = api.init(key)
        return params

    shapes = jax.eval_shape(init, jax.random.key(0))
    return box["specs"], shapes


def _leaves(specs, shapes, path=""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _leaves(v, shapes[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", v, tuple(shapes[k].shape)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_resolve_spec_matches_the_reference_on_every_leaf(fake_world, multi_pod):
    """Every parameter leaf of every arch of the registry at full size, under
    training and serving rules: the port's ``resolve_spec`` on the
    production ``DeviceMesh`` is the reference's; a stacked leaf's per-layer
    spec (the port's layout) is the stacked one without its "unit" dim; the
    port's ``api.specs()`` is the reference's tree."""
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert mesh.shape == ((2, 16, 16) if multi_pod else (16, 16))
    ref_mesh = _ref_mesh(mesh)
    checked = 0
    for name in ARCHS:
        specs, shapes = _ref_specs(name)
        assert build(get_arch(name)).specs() == specs, name
        for serving in (False, True):
            port, ref = default_rules(mesh, serving=serving), jlogical.default_rules(
                ref_mesh, serving=serving)
            assert port.rules == ref.rules
            for path, names, shape in _leaves(specs, shapes):
                want = tuple(jlogical.resolve_spec(names, shape, ref))
                got = resolve_spec(names, shape, port)
                assert got == want, (name, serving, path, got, want)
                if names[0] == "unit":
                    assert resolve_spec(names[1:], shape[1:], port) == got[1:], (name, path)
                checked += 1
    assert checked > 400  # 236 leaves over the registry, under two rule sets


def test_placements_and_param_sharding():
    """``placements``: a dim on ("pod", "data") is Shard on both mesh dims;
    ``param_sharding`` of a reduced model: each weight of the port's layout
    (one entry per layer) takes the reference's stacked names without
    "unit"."""
    assert placements(P(("pod", "data"), None, "model"), MULTI) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), POD) == (Shard(1), Replicate())
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    rules = default_rules(mesh)
    for name in ("qwen3-4b", "jamba-v0.1-52b", "whisper-tiny"):
        cfg = get_arch(name).reduced()
        api = build(cfg)
        params = api.init(torch.Generator().manual_seed(0), "cpu")
        sh = param_sharding(api.specs(), params, rules)
        specs = api.specs()
        flat = dict(params.named_parameters())
        n = 0
        for key, p in flat.items():
            parts = key.split(".")
            node, tree = sh, specs
            if parts[0] in ("layers", "enc", "dec"):
                i = int(parts[1])
                tree = specs["unit"][f"b{i % cfg.unit_size}"] if parts[0] == "layers" else \
                    specs[parts[0]]
                node = sh[parts[0]][i]
                parts = parts[2:]
            for part in parts[:-1]:
                node, tree = node[part], tree[part]
            names = tree[parts[-1]]
            names = names[1:] if names[:1] == ("unit",) else names
            assert node[parts[-1]].spec == resolve_spec(names, p.shape, rules), (name, key)
            n += 1
        assert n == len(flat)


def test_make_test_mesh_and_constrain_outside_rules(fake_world):
    """``make_test_mesh`` over a group of four; ``constrain`` returns its
    input unchanged outside a rules context, at a world of one and on a plain
    tensor inside one."""
    x = torch.randn(4, 8)
    assert constrain(x, "batch", "embed_act") is x
    fake_world(4)
    mesh = make_test_mesh(2, 2, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (2, 2)
    with use_rules(default_rules(mesh)):
        assert constrain(x, "batch", "embed_act") is x
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1), size=lambda: 1)
    with use_rules(default_rules(one)):
        assert constrain(x, "batch", "embed_act") is x
