"""The port's log line on the `tpu:` configuration: every key of the
flagship YAML's `tpu:` section, and every `tpu.*` key the JAX package reads,
is either honoured by the port or named in the line as ignored.
"""

import os
import re

import pytest

from shapeclipper_torch.config import options
from shapeclipper_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "options", "pix3d", "config.yaml")


def _jax_tpu_keys():
    """The keys the JAX package reads as `...get("tpu", {}).get("KEY")` or
    `tpu.get("KEY")`, from its source text."""
    keys = set()
    pat = re.compile(r"""tpu["']?[^\n]{0,30}?\.get\(["']([a-z_]+)["']""")
    for root, _, files in os.walk(os.path.join(REPO, "shapeclipper_tpu")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    keys.update(pat.findall(f.read()))
    keys.discard("tpu")
    return keys


def test_every_tpu_key_is_honoured_or_named():
    opt = options.load_options(FLAGSHIP)
    yaml_keys = set(opt.tpu)
    jax_keys = _jax_tpu_keys()
    assert {"profile_iters", "eval_pipeline", "encoder_dtype"} <= jax_keys
    honoured = set(trainer.HONOURED_TPU_KEYS)
    ignored = set(trainer.IGNORED_TPU_KEYS)
    assert not honoured & ignored
    assert yaml_keys | jax_keys <= honoured | ignored, \
        (yaml_keys | jax_keys) - honoured - ignored
    note = trainer.tpu_keys_note(opt)
    named = set(re.search(r"ignores tpu\.\{([^}]*)\}", note).group(1)
                .split(", "))
    assert named == (yaml_keys & ignored)
    assert "float32," not in note.split(":")[1]
    # honoured keys are reported with the values in force
    assert "encoders in bfloat16, implicit MLPs in bfloat16" in note


@pytest.mark.parametrize("extra, value, in_force", [
    pytest.param("profile_iters", [1, 3], "profiler window iterations 1-2",
                 id="profile_iters"),
    pytest.param("eval_pipeline", False, "evaluation serial",
                 id="eval_pipeline"),
    pytest.param("device_isosurface", True, "surface sampling on the device",
                 id="device_isosurface")])
def test_keys_outside_the_yaml_are_named_when_set(extra, value, in_force):
    """A key the YAML does not set, or sets to its default, is named with
    the value in force when set: the profiler window, the serial
    evaluation (tpu.eval_pipeline), the device surface sampler
    (tpu.device_isosurface); none of them is named as ignored."""
    opt = options.load_options(FLAGSHIP)
    assert in_force not in trainer.tpu_keys_note(opt)
    opt.tpu[extra] = value
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32")
    note = trainer.tpu_keys_note(opt)
    ignored = re.search(r"ignores tpu\.\{([^}]*)\}", note).group(1)
    assert extra in trainer.HONOURED_TPU_KEYS
    assert extra not in ignored
    assert in_force in note
    assert "encoders in float32, implicit MLPs in float32" in note


def test_merge_flags_are_honoured():
    """The three merge flags are honoured, true in the flagship YAML (and
    when absent, as in the JAX package), and the note names the merged
    parts in force; no profiler window unless asked."""
    opt = options.load_options(FLAGSHIP)
    flags = ("merge_encoders", "merge_flip_estimator", "merge_nn_render")
    assert set(flags) <= set(trainer.HONOURED_TPU_KEYS)
    assert all(opt.tpu[k] is True for k in flags)
    note = trainer.tpu_keys_note(opt)
    assert "merged {" + ", ".join(flags) + "}" in note
    assert "profiler window off" in note
    for k in flags:
        del opt.tpu[k]
    assert "merged {" + ", ".join(flags) + "}" in trainer.tpu_keys_note(opt)
    opt.tpu.update(dict.fromkeys(flags, False))
    assert "merged nothing" in trainer.tpu_keys_note(opt)


def test_build_networks_logs_the_note(tmp_path, capsys):
    opt = options.load_options(FLAGSHIP)
    opt.output_path = str(tmp_path)
    opt.update(seed=0, resume=False)
    runner = trainer.Runner(opt, "cpu")
    runner.build_networks(opt)
    assert trainer.tpu_keys_note(opt) in capsys.readouterr().out
