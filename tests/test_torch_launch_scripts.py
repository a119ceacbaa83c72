"""The port's launch scripts (scripts/run_{Panc,brats19,ISLES22}_torch.sh)
against the JAX package's (scripts/run_{Panc,brats19,ISLES22}.sh): each
script runs its package's train CLI, and its flags, parsed by that
package's parser, give the same config field by field, but `device` (the
port's own field, cuda in the port's scripts)."""

import dataclasses
import os
import shlex

import pytest

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu_torch import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"Panc": "pancreas", "brats19": "brats19", "ISLES22": "isles22"}


def _command(path):
    """(the module run by `python -m`, its argv) of a launch script."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    lines = [line for line in text.splitlines() if line.strip().startswith("python")]
    assert len(lines) == 1, path
    words = shlex.split(lines[0])
    i = words.index("-m")
    return words[i + 1], words[i + 2:]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_launch_script_gives_the_jax_config(name):
    dataset = SCRIPTS[name]
    jmodule, jargv = _command(os.path.join(REPO, "scripts", f"run_{name}.sh"))
    tmodule, targv = _command(os.path.join(REPO, "scripts", f"run_{name}_torch.sh"))
    assert jmodule == f"dycon_paper_replication_tpu.cli.train_{dataset}"
    assert tmodule == f"dycon_paper_replication_tpu_torch.cli.train_{dataset}"
    want = jconfig.config_from_args(dataset, jargv)
    got = tconfig.config_from_args(dataset, targv)
    assert got.device == "cuda"
    fields = {f.name for f in dataclasses.fields(want)}
    assert {f.name for f in dataclasses.fields(got)} - fields == {"device"}
    assert fields - {f.name for f in dataclasses.fields(got)} == set()
    for field in sorted(fields):
        assert getattr(got, field) == getattr(want, field), field
    assert got.snapshot_path() == want.snapshot_path()
