"""Headless CLI smoke tests: render + stats subcommands, metrics JSON,
film checkpoint resume — the front door a reference user lands on.
"""

import json

import pytest

from tests.util_scenes import cornell_glb


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    """The generated cornell box written as a .glb file."""
    pytest.importorskip("PIL")  # the loader decodes the embedded PNGs
    return cornell_glb(tmp_path_factory.mktemp("scene"))


def _render_args(tmp_path, scene_file, extra=()):
    return ["render", "--scene", scene_file, "--cpu",
            "--size", "64x48", "--spp", "2", "--bounces", "1",
            "--camera-pos", "0,1.25,1.18", "--look-at", "0,1.1,-1.25",
            "--vfov", "75", "--out", str(tmp_path / "out.png"),
            *extra]


@pytest.mark.slow
def test_cli_render_and_metrics(tmp_path, capsys, scene_file):
    from dustraytracer.apps.cli import main

    metrics = tmp_path / "metrics.json"
    rc = main(_render_args(tmp_path, scene_file,
                           ["--metrics-out", str(metrics)]))
    assert rc == 0
    png = (tmp_path / "out.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert png[16:24] == (64).to_bytes(4, "big") + (48).to_bytes(4, "big")
    m = json.loads(metrics.read_text())
    assert m["spp"] == 2
    assert m["mrays_per_second"] > 0
    assert m["triangles"] == 36


@pytest.mark.slow
def test_cli_checkpoint_resume(tmp_path, capsys, scene_file):
    from dustraytracer.apps.cli import main

    ckpt = tmp_path / "film.npz"
    assert main(_render_args(tmp_path, scene_file,
                             ["--checkpoint", str(ckpt)])) == 0
    assert ckpt.exists()
    # resume: --spp is the TOTAL sample target; 2 are checkpointed, so
    # a --spp 4 re-run renders exactly 2 more
    metrics = tmp_path / "m2.json"
    args = _render_args(tmp_path, scene_file,
                        ["--checkpoint", str(ckpt),
                         "--metrics-out", str(metrics)])
    args[args.index("--spp") + 1] = "4"
    assert main(args) == 0
    m = json.loads(metrics.read_text())
    assert m["spp"] == 2, m


def test_cli_stats(capsys, scene_file):
    from dustraytracer.apps.cli import main

    assert main(["stats", "--scene", scene_file, "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["triangles"] == 36
    assert out["textures"] == 2
    assert out["materials"] >= 1
    assert out["objects"] >= 1
