"""Headline-vs-shipped-default contract (verdict-r4 item 7).

Round 3 published a headline number measured in a non-default fast-merge
mode; round 4 re-pointed it at the shipped default by hand. This test pins
the contract structurally: bench.py's headline config must equal the
shipped cfg/ackerman_synth.cfg on every field EXCEPT the declared shape/
scene overrides (bench.STRESS_OVERRIDES), so filter semantics — mergeMode,
selectTopK, usePallas, mergeCompactK, minSeparation, ... — can never drift
from what a user gets by running the shipped config.
"""
import dataclasses

import bench
from phdslam_tpu.config import load_config


def test_headline_config_matches_shipped_defaults():
    shipped = load_config("cfg/ackerman_synth.cfg")
    stress = bench.dense_stress_config()
    drift = {
        f.name: (getattr(shipped, f.name), getattr(stress, f.name))
        for f in dataclasses.fields(shipped)
        if f.name not in bench.STRESS_OVERRIDES
        and getattr(shipped, f.name) != getattr(stress, f.name)
    }
    assert not drift, (
        "bench headline config drifted from shipped defaults on "
        f"non-shape fields: {drift}")


def test_stress_overrides_are_shape_only():
    # the allowed-override list itself must not quietly grow a semantics
    # knob: every entry is a shape/scene field, none is a mode switch
    semantic = {"mergeMode", "selectTopK", "usePallas", "mergeCompactK",
                "minSeparation", "minFeatureWeight", "mergeMinWeight",
                "filterType", "motionType", "mapType", "weightingScheme"}
    assert not semantic & set(bench.STRESS_OVERRIDES)


def test_main_uses_dense_stress_config():
    # main() must take its headline from dense_stress_config() (the
    # function this contract covers), not a private literal
    import inspect
    src = inspect.getsource(bench.main)
    assert "dense_stress_config()" in src
