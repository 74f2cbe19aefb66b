"""The port's OCR-VQA fetcher (visper_lm_tpu_torch/data/download_ocr_vqa.py)
against the JAX package's script, offline: a dataset JSON whose image URLs
are `file://` paths under tmp_path (two present on the disk, one missing),
run through both with the same arguments. The files each writes and the
line each prints are the same, with and without --limit, and --verify-only
fetches nothing. Also: every module of the JAX package has a twin of the
same path in the port.
"""

import json
import os
import sys

import pytest

from visper_lm_tpu.data import download_ocr_vqa as jdl

from visper_lm_tpu_torch.data import download_ocr_vqa as tdl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(tmp_path):
    """Three records: two images on the disk (.png, and one with no
    extension: saved as .jpg), one URL that points at nothing."""
    src = tmp_path / "mirror"
    src.mkdir()
    (src / "a.png").write_bytes(b"\x89PNG first")
    (src / "b").write_bytes(b"second image")
    data = {"k1": {"imageURL": (src / "a.png").as_uri(), "questions": ["q?"]},
            "k2": {"imageURL": (src / "b").as_uri()},
            "k3": {"imageURL": (src / "gone.gif").as_uri()}}
    path = tmp_path / "dataset.json"
    path.write_text(json.dumps(data))
    return path


def _jax_main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["download_ocr_vqa.py"] + argv)
    jdl.main()


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("limit", [None, 2])
def test_fetch_from_file_urls_matches_jax(tmp_path, monkeypatch, capsys, limit):
    dataset = _dataset(tmp_path)
    extra = [] if limit is None else ["--limit", str(limit)]
    outs = {}
    for name in ("jax", "port"):
        argv = ["--dataset-json", str(dataset), "--output-dir", str(tmp_path / name)] + extra
        if name == "jax":
            _jax_main(monkeypatch, argv)
        else:
            counts = tdl.main(argv)
        outs[name] = capsys.readouterr().out
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    want = {"k1.png": b"\x89PNG first", "k2.jpg": b"second image"}
    assert _files(tmp_path / "port") == want
    assert counts == (2, 0 if limit else 1)
    assert outs["port"].splitlines()[-1] == outs["jax"].splitlines()[-1] == (
        f"images present: 2, missing/failed: {counts[1]}")
    if limit is None:
        # the missing file is reported, then counted, by both
        assert outs["port"].startswith("failed k3: ") and outs["jax"].startswith("failed k3: ")


def test_verify_only_fetches_nothing(tmp_path, monkeypatch, capsys):
    dataset = _dataset(tmp_path)
    out = tmp_path / "images"
    assert tdl.main(["--dataset-json", str(dataset), "--output-dir", str(out),
                     "--verify-only"]) == (0, 3)
    assert os.listdir(out) == []
    (out / "k2.jpg").write_bytes(b"already here")
    assert tdl.main(["--dataset-json", str(dataset), "--output-dir", str(out),
                     "--verify-only"]) == (1, 2)
    port = capsys.readouterr().out
    _jax_main(monkeypatch, ["--dataset-json", str(dataset), "--output-dir", str(out),
                            "--verify-only"])
    assert capsys.readouterr().out.splitlines()[-1] == port.splitlines()[-1]
    assert _files(out) == {"k2.jpg": b"already here"}


def test_every_jax_module_has_a_twin():
    """Each .py file of visper_lm_tpu/ has one at the same path in
    visper_lm_tpu_torch/."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root)
                for f in files if f.endswith(".py")}

    missing = modules("visper_lm_tpu") - modules("visper_lm_tpu_torch")
    assert not missing, sorted(missing)
