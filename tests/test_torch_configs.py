"""The port's config dicts and config files: `PENDULUM_TUNED_CONFIG` and
`PARTICLE_TUNED_CONFIG` (and the demo dicts) equal `yaml.safe_load` of
`demo/*.yaml` key for key, types included; the `config.yaml` that
`save_progress` writes reads back unchanged for all four, and its text for
the pendulum demo config is pinned by a hash `chip_smoke.py` shares;
`load_config` without PyYAML raises an ImportError that names it."""

import hashlib
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from dust_tpu_torch.experiments import (
    PARTICLE_DEMO_CONFIG,
    PARTICLE_TUNED_CONFIG,
    PENDULUM_DEMO_CONFIG,
    PENDULUM_TUNED_CONFIG,
    load_config,
)
from dust_tpu_torch.utils.helper import save_progress

DEMO = Path(__file__).resolve().parent.parent / "demo"
CONFIGS = {
    "pendulum_config": PENDULUM_DEMO_CONFIG,
    "pendulum_config_tuned": PENDULUM_TUNED_CONFIG,
    "particle_config": PARTICLE_DEMO_CONFIG,
    "particle_config_tuned": PARTICLE_TUNED_CONFIG,
}
# SHA-256 of the config.yaml that `save_progress` writes for
# PENDULUM_DEMO_CONFIG (yaml.dump's text); chip_smoke.py's phase 37 holds
# the file the pendulum demo's --save writes on the card to it
PENDULUM_CONFIG_YAML_SHA256 = \
    "12024aca82619a0f06b87390e51d51acf0c8051ccbafba6a13f2ec64cf4f3919"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_dicts_equal_the_yaml_files(name):
    want = yaml.safe_load((DEMO / f"{name}.yaml").read_text())
    assert CONFIGS[name] == want
    # ints stay ints and floats floats
    assert json.dumps(CONFIGS[name], sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    assert load_config(DEMO / f"{name}.yaml") == CONFIGS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_save_progress_config_yaml_reads_back(tmp_path, name):
    folder = save_progress(name, params=CONFIGS[name], root=tmp_path)
    text = (folder / "config.yaml").read_text()
    assert yaml.safe_load(text) == CONFIGS[name]


def test_save_progress_config_yaml(tmp_path):
    folder = save_progress("run", data={"Cost": np.arange(3.0)},
                           params=PENDULUM_DEMO_CONFIG, root=tmp_path)
    text = (folder / "config.yaml").read_text()
    assert hashlib.sha256(text.encode()).hexdigest() == \
        PENDULUM_CONFIG_YAML_SHA256
    with (folder / "data.pkl").open("rb") as fh:
        np.testing.assert_array_equal(pickle.load(fh)["Cost"], np.arange(3.0))


def test_load_config_without_pyyaml_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_config(DEMO / "pendulum_config.yaml")
