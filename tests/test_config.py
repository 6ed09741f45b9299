"""Config system tests (reference config/SystemConfigTest.java)."""

import json
import warnings

import pytest

from fspann.config import SystemConfig, load_config


def test_defaults():
    cfg = SystemConfig().validate()
    assert cfg.paper.m == 24 and cfg.paper.lam == 2
    assert cfg.paper.num_groups == 18
    assert cfg.paper.code_bits == 48 and cfg.paper.code_words == 2
    assert cfg.runtime.hard_cap == 20_000
    assert cfg.runtime.effective_probes() == 5
    assert cfg.eval.max_k == 100


def test_load_with_profile(tmp_path):
    cfg = load_config("configs/sift1m.json", "SIFT_P4_FAST")
    assert cfg.paper.m == 20 and cfg.paper.tables == 5
    assert cfg.runtime.probe_override == 4
    assert cfg.runtime.effective_probes() == 4
    assert cfg.runtime.refinement_limit == 8000
    assert cfg.keys.ops_threshold == 500_000_000
    assert cfg.profile_name == "SIFT_P4_FAST"
    assert len(cfg.source_sha256) == 64
    # base (no profile) keeps defaults from the file
    base = load_config("configs/sift1m.json")
    assert base.paper.m == 24 and base.runtime.probe_override == -1


def test_unknown_profile_raises():
    with pytest.raises(KeyError, match="NOPE"):
        load_config("configs/sift1m.json", "NOPE")


def test_reference_shaped_config(tmp_path):
    """List-shaped profiles + vestigial keys load with warnings, not errors."""
    p = tmp_path / "ref.json"
    p.write_text(json.dumps({
        "opsThreshold": 123,
        "paper": {"m": 10, "lambda": 2, "divisions": 4, "tables": 2,
                  "seed": 7, "enabled": True},
        "runtime": {"probeOverride": 3, "refinementLimit": 5000,
                    "maxCandidateFactor": 5, "maxRelaxationDepth": 8},
        "profiles": [
            {"name": "FAST", "description": "x",
             "overrides": {"runtime": {"probeOverride": 2}}},
        ],
    }))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = load_config(str(p), "FAST")
    assert cfg.paper.m == 10
    assert cfg.runtime.probe_override == 2
    assert cfg.keys.ops_threshold == 123
    assert any("maxCandidateFactor" in str(x.message) for x in w)


def test_invariant_clamping(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({
        "runtime": {"refinementLimit": 5, "maxGlobalCandidates": 3},
        "eval": {"kVariants": [1, 10, 100]},
    }))
    cfg = load_config(str(p))
    # maxGlobalCandidates >= maxK; refinementLimit >= maxK
    assert cfg.runtime.max_global_candidates >= 100
    assert cfg.runtime.refinement_limit >= 100


def test_overrides_layer():
    cfg = load_config("configs/sift1m.json", "SIFT_P6_BALANCED",
                      overrides={"runtime": {"probeOverride": 9}})
    assert cfg.runtime.probe_override == 9
    assert cfg.paper.m == 24


def test_all_bundled_configs_parse():
    for path in ("configs/sift1m.json", "configs/glove100.json",
                 "configs/redcaps.json", "configs/gist1m.json",
                 "configs/deep10m.json"):
        data = json.load(open(path))
        for name in data.get("profiles", {}):
            cfg = load_config(path, name)
            cfg.paper.validate()


def test_cloak_config_block(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({
        "cloak": {"enabled": True, "rate": 0.5, "mode": "uniform"},
    }))
    cfg = load_config(str(p))
    assert cfg.cloak.enabled and cfg.cloak.rate == 0.5
    assert cfg.cloak.mode == "uniform"
    assert not SystemConfig().cloak.enabled   # default off


def test_routing_mode_alias_and_validation():
    import dataclasses
    import json
    import tempfile

    import pytest

    from fspann.config import SystemConfig, RuntimeConfig, load_config

    with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
        json.dump({"runtime": {"routingMode": "scan", "rerankLimit": 2000}}, f)
        f.flush()
        cfg = load_config(f.name)
    assert cfg.runtime.routing_mode == "scan"
    assert cfg.runtime.effective_refinement() == 2000

    bad = SystemConfig(runtime=RuntimeConfig(routing_mode="warp"))
    with pytest.raises(ValueError, match="routing_mode"):
        bad.validate()


def test_mesh_merge_values_and_deprecated_alias(tmp_path):
    from fspann.config import RuntimeConfig

    p = tmp_path / "c.json"
    p.write_text(json.dumps({"runtime": {"mesh_merge": "ici"}}))
    assert load_config(str(p)).runtime.mesh_merge == "device"
    for v in ("device", "host"):
        cfg = SystemConfig(runtime=RuntimeConfig(mesh_merge=v)).validate()
        assert cfg.runtime.mesh_merge == v
    with pytest.raises(ValueError, match="mesh_merge"):
        SystemConfig(runtime=RuntimeConfig(mesh_merge="nccl")).validate()
