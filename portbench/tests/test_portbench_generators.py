"""The generators repeat by seed, make the sizes the mixes state, and the
frozen copies give what their sources give."""

from __future__ import annotations

import itertools
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, weights as wmod
from portbench.gen import pdn as pdn_gen, traffic as tgen
from portbench.gen.telemetry import Telemetry

ROOT = Path(__file__).resolve().parents[2]
POOL = json.loads((ROOT / "portbench/traffic/prefill_pool.json").read_text())
BIG = 2**31 + 12345


def _take(seed, n, p=POOL):
    return list(itertools.islice(tgen.forwards(p, seed), n))


def test_forwards_repeat_by_seed_and_differ_between_seeds():
    assert _take(BIG, 40) == _take(BIG, 40)
    assert [f.length for f in _take(BIG, 40)] != [f.length for f in _take(BIG + 1, 40)]


@pytest.mark.parametrize("seed", [0, 7, BIG, 2**40 + 3])
def test_forwards_are_one_length_within_the_budget_and_serve_each_request_once(seed):
    fwds = _take(seed, 64)
    seen = set()
    for f in fwds:
        assert len(f.requests) == POOL["budget_tokens"] // f.length
        assert len(f.requests) * f.length <= POOL["budget_tokens"]
        assert seen.isdisjoint(f.requests)
        seen.update(f.requests)
    # each deck serves every length once: any 16 forwards' lengths come from
    # at most two decks, and over many decks the lengths are uniform
    counts = Counter(f.length for f in _take(seed, 16 * 20))
    assert set(counts) == set(tgen.lengths(POOL).tolist())
    assert max(counts.values()) - min(counts.values()) <= 2


def test_request_lengths_are_drawn_in_proportion_to_one_over_length():
    stream = tgen.requests(POOL, BIG)
    deck = sum(POOL["budget_tokens"] // int(L) for L in tgen.lengths(POOL))
    counts = Counter(itertools.islice(stream, deck))
    for L, c in counts.items():
        assert c == POOL["budget_tokens"] // L
    assert counts[256] == 64 and counts[4096] == 4


def test_pdn_copy_matches_the_ports_datacenter():
    from repro_torch.pdn.tree import build_datacenter

    for kw in ({}, {"n_halls": 2, "racks_per_hall": 3, "servers_per_rack": 2,
                    "gpus_per_server": 4}):
        mine, theirs = pdn_gen.build_datacenter(**kw), build_datacenter(**kw)
        for k, v in mine.items():
            np.testing.assert_array_equal(v, getattr(theirs, k))
    full = pdn_gen.build_datacenter()
    assert full["dev_l"].shape == (12288,) and full["node_cap"].shape == (1637,)
    assert full["dev_u"].sum() / full["node_cap"][0] == pytest.approx(1 / 0.85**3)


@pytest.mark.parametrize("family,mean,burst,prob", [("ssm", 574.0, 28.0, 0.02),
                                                    ("dense", 616.0, 42.0, 0.05)])
def test_telemetry_repeats_by_seed_and_follows_the_draw_rule(family, mean, burst, prob):
    from repro_torch.power.power_model import arch_power_profile

    assert arch_power_profile(family) == pytest.approx((mean, burst, prob))
    a, b = Telemetry(family, 700.0, 12288, BIG), Telemetry(family, 700.0, 12288, BIG)
    draws = [a.draw() for _ in range(3)]
    for d in draws:
        np.testing.assert_array_equal(d, b.draw())
        assert set(np.unique(d)) <= {mean, mean + burst}
    share = np.mean([d > mean for d in draws])
    assert prob / 2 < share < prob * 1.5
    assert not np.array_equal(draws[0], Telemetry(family, 700.0, 12288, BIG + 1).draw())


@pytest.mark.parametrize("name,family", [("stablelm-12b", "dense"), ("mamba2-1.3b", "ssm")])
def test_each_config_states_the_ports_family(name, family):
    config = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    assert config["family"] == family == harness.arch(config).family


@pytest.mark.parametrize("name", ["stablelm-12b", "mamba2-1.3b"])
def test_weights_repeat_by_seed_and_follow_the_configs_rules(name):
    from repro_torch.models import build

    config = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    cfg = harness.arch(config, tiny=True)
    meta = build(cfg).init(None, torch.device("meta"))
    leaves = wmod.layout(meta)
    a = wmod.make(leaves, config["init"], BIG, torch.device("cpu"))
    b = wmod.make(leaves, config["init"], BIG, torch.device("cpu"))
    c = wmod.make(leaves, config["init"], BIG + 1, torch.device("cpu"))
    assert list(a) == [n for n, _ in leaves]
    for n, s in leaves:
        assert a[n].shape == s and a[n].dtype == torch.float32
        assert torch.equal(a[n], b[n])
        kind = config["init"][n.rsplit(".", 1)[-1]][0]
        if kind == "normal":
            assert not torch.equal(a[n], c[n])
        else:
            assert torch.equal(a[n], c[n])
    w = a["layers.0." + ("attn.wq" if "attn" in str(leaves) else "ssd.in_proj")]
    assert float(w.std()) == pytest.approx(w.shape[0] ** -0.5, rel=0.1)
    params = wmod.port_params(meta, a)
    for (n, p), (n2, _) in zip(params.named_parameters(), leaves):
        assert n == n2 and p.data_ptr() == a[n].data_ptr()
