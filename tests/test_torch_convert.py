"""`vlsa_tpu_torch.data.convert` (the feature half) against vlsa_tpu's
`convert_dir`: from `.pt`, `.h5` and `.npy` slide files into `.npy` (f32,
f16) and `.q8npz` (int8) stores.  The arrays each writes are compared, not
the files' bytes (zip timestamps differ): exactly equal, and with the same
dtypes and names."""
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from vlsa_tpu.data.convert import convert_dir as jax_convert_dir
from vlsa_tpu_torch.data.convert import convert_dir
from vlsa_tpu_torch.data.native_loader import read_q8_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{kind: directory} of three slides each: .pt ({"features": tensor}
    and a bare tensor), .h5 and .npy (f32 and f16), plus a file that is no
    slide; one slide has a zero row (scale 0, inv 0)."""
    rng = np.random.default_rng(2)
    slides = {f"s{i}": rng.normal(size=(n, 24)).astype(np.float32)
              for i, n in enumerate((17, 5, 40))}
    slides["s1"][2] = 0.0
    root = tmp_path_factory.mktemp("src")
    dirs = {k: root / k for k in ("pt", "h5", "npy", "npy_f16")}
    for d in dirs.values():
        d.mkdir()
    for i, (sid, f) in enumerate(slides.items()):
        t = torch.from_numpy(f)
        torch.save({"features": t} if i % 2 == 0 else t, str(dirs["pt"] / f"{sid}.pt"))
        with h5py.File(str(dirs["h5"] / f"{sid}.h5"), "w") as hf:
            hf.create_dataset("features", data=f)
        np.save(str(dirs["npy"] / f"{sid}.npy"), f)
        np.save(str(dirs["npy_f16"] / f"{sid}.npy"), f.astype(np.float16))
    (dirs["npy"] / "notes.txt").write_text("not a slide")
    return {k: str(v) for k, v in dirs.items()}


def _arrays(path):
    if path.endswith(".q8npz"):
        with np.load(path) as z:
            return {k: z[k] for k in sorted(z.files)}
    return {"": np.load(path)}


@pytest.mark.parametrize("src", ["pt", "h5", "npy", "npy_f16"])
@pytest.mark.parametrize("dtype", ["f32", "f16", "int8"])
def test_converted_arrays_match_jax(sources, tmp_path, src, dtype):
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert convert_dir(sources[src], got_dir, dtype=dtype, verbose=False) == 3
    jax_convert_dir(sources[src], want_dir, dtype=dtype, verbose=False)
    ext = ".q8npz" if dtype == "int8" else ".npy"
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == \
        [f"s{i}{ext}" for i in range(3)]
    for name in os.listdir(want_dir):
        got, want = _arrays(os.path.join(got_dir, name)), _arrays(os.path.join(want_dir, name))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
        if dtype == "int8":
            assert read_q8_info(os.path.join(got_dir, name)) == got["q"].shape
            assert got["q"].dtype == np.int8
            assert got["scale"].dtype == got["inv"].dtype == np.float32
        else:
            assert got[""].dtype == (np.float16 if dtype == "f16" else np.float32)


def test_f16_flag_and_cli(sources, tmp_path):
    """`--f16` is `--dtype f16`; the module runs as a CLI."""
    convert_dir(sources["npy"], str(tmp_path / "flag"), f16=True, verbose=False)
    out = subprocess.run([sys.executable, "-m", "vlsa_tpu_torch.data.convert", "--src",
                          sources["npy"], "--dst", str(tmp_path / "cli"), "--dtype", "f16"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "wrote 3 feature files" in out.stdout
    for name in sorted(os.listdir(tmp_path / "cli")):
        np.testing.assert_array_equal(np.load(str(tmp_path / "flag" / name)),
                                      np.load(str(tmp_path / "cli" / name)))
    with pytest.raises(ValueError, match="f32, f16 or int8"):
        convert_dir(sources["npy"], str(tmp_path / "bad"), dtype="bf16")
