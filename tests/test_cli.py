"""CLI + scene persistence: the app-shell equivalent (reference C14)."""

import os

import json

import numpy as np
import pytest

from piet_tpu.cli import main
from piet_tpu.scene.fixtures import make_path_test
from piet_tpu.scene.scene import Scene
from piet_tpu.utils.png import read_png


def test_scene_save_load_roundtrip(tmp_path):
    scene = make_path_test()
    p = str(tmp_path / "s.npz")
    scene.save(p)
    back = Scene.load(p)
    for f in ("tags", "colors", "widths", "bboxes", "pt_offset", "n_pts",
              "points"):
        np.testing.assert_array_equal(getattr(scene, f), getattr(back, f))


def test_cli_render_writes_png(tmp_path):
    out = str(tmp_path / "t.png")
    npz = str(tmp_path / "t.npz")
    rc = main(["render", "--scene", "path_test", "--width", "320",
               "--height", "832", "--fine-impl", "xla", "--out", out,
               "--save-scene", npz])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (832, 320, 4)
    assert os.path.exists(npz)
    # render from the saved scene gives the identical image
    out2 = str(tmp_path / "t2.png")
    rc = main(["render", "--load", npz, "--width", "320", "--height", "832",
               "--fine-impl", "xla", "--scene", "path_test", "--out", out2])
    assert rc == 0
    np.testing.assert_array_equal(read_png(out2), img)


def test_cli_info():
    assert main(["info"]) == 0


def test_cli_animate_writes_frames(tmp_path):
    outdir = str(tmp_path / "frames")
    rc = main(["animate", "--scene", "animated", "--frames", "3",
               "--chunk", "2", "--width", "256", "--height", "256",
               "--fine-impl", "xla", "--outdir", outdir])
    assert rc == 0
    imgs = [read_png(os.path.join(outdir, f"frame_{i:04d}.png"))
            for i in range(3)]
    assert all(im.shape == (256, 256, 4) for im in imgs)
    # Frames at different t must actually differ (it IS an animation).
    assert not np.array_equal(imgs[0], imgs[2])


@pytest.mark.parametrize("cmd", ["bench", "profile"])
def test_cli_timing_refuses_cpu_without_flag(cmd):
    """A timing never falls back to the CPU: without a GPU it needs
    ``--cpu``."""
    with pytest.raises(RuntimeError, match="GPU"):
        main([cmd, "--scene", "path_test", "--frames", "1"])


def test_cli_bench_cpu_reports_device(capsys, monkeypatch):
    from piet_tpu import compile_cache
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "")
    rc = main(["--cpu", "bench", "--scene", "path_test", "--width", "128",
               "--height", "128", "--fine-impl", "xla", "--frames", "1"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] >= 1 and out["ms_per_frame"] > 0
