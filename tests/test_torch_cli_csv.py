"""The port's click-to-video CLI on a csv manifest whose rows carry their
first images, against the JAX CLI (see ``tests/test_torch_cli.py``).

Rows: an image with its click mask in the ``<image dir>_mask`` folder, an
image without a mask, and an image file that does not exist (both CLIs drop
that row). Both CLIs write the same GIF names and snapshot keys; the port's
videos equal its pipeline driven by hand (the image and mask cropped, the
mask at latent size, ``__call__``), at ``--batch_size 2``: one request of
two clips, whose seed is the first clip's. A csv row with an empty image
cell is a row without an image for the port (its first frame from the
T2I); the JAX CLI reads the cell as pandas' NaN and drops the row.
"""

import csv
import os

import numpy as np
import pytest

from tests.test_torch_cli import (
    PROMPTS,
    SEED,
    call_by_hand,
    check_same_outputs,
    run_both,
    write_tiny_directory,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from PIL import Image

    root = str(tmp_path_factory.mktemp("cli_csv"))
    images = os.path.join(root, "images")
    os.makedirs(images)
    os.makedirs(images + "_mask")
    rs = np.random.RandomState(0)
    for name in ("a.png", "b.png"):
        Image.fromarray((rs.rand(80, 120, 3) * 255).astype(np.uint8)).save(
            os.path.join(images, name))
    Image.fromarray(((rs.rand(80, 120) > 0.5) * 255).astype(np.uint8)).save(
        os.path.join(images + "_mask", "a.png"))
    return {"root": root, "files": write_tiny_directory(root),
            "images": images}


def _manifest(tiny, rows, name):
    path = os.path.join(tiny["root"], name)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["prompt", "image"])
        w.writerows(rows)
    return path


def test_csv_manifest_with_images(tiny, monkeypatch):
    img = tiny["images"]
    manifest = _manifest(tiny, [
        [PROMPTS[0], os.path.join(img, "a.png")],
        ["a missing file", os.path.join(img, "missing.png")],
        [PROMPTS[1], os.path.join(img, "b.png")]], "rows.csv")
    jdir, result, videos = run_both(tiny, manifest, monkeypatch,
                                    "--batch_size", "2")
    check_same_outputs(jdir, result, videos)
    assert [n.split("-")[0] for n in result["files"]] == ["0", "2"]
    assert result["stats"]["t2i"] == []
    names = result["files"]
    want = call_by_hand(tiny, PROMPTS, [os.path.join(img, "a.png"),
                                        os.path.join(img, "b.png")],
                        [os.path.join(img + "_mask", "a.png"), None],
                        [SEED, SEED])
    for i, name in enumerate(names):
        np.testing.assert_array_equal(videos[name], want[i:i + 1])


def test_csv_empty_image_cell_is_a_row_without_image(tiny):
    from followyourclick_tpu.cli.inference import (
        load_prompt_manifest as jax_manifest,
    )
    from followyourclick_tpu_torch.cli.inference import load_prompt_manifest

    img = tiny["images"]
    manifest = _manifest(tiny, [[PROMPTS[0], ""],
                                [PROMPTS[1], os.path.join(img, "a.png")]],
                         "empty_cell.csv")
    items = load_prompt_manifest(manifest)
    assert [(it["idx"], it["image"], it["mask"]) for it in items] == [
        (0, None, None),
        (1, os.path.join(img, "a.png"),
         os.path.join(img + "_mask", "a.png"))]
    assert [it["idx"] for it in jax_manifest(manifest)] == [1]


@pytest.mark.parametrize("world", [1, 2, 3])
def test_process_shard_splits_as_jax(monkeypatch, world):
    """One process a card: rank r of ``WORLD_SIZE`` takes the JAX package's
    contiguous slice of the manifest (``jax.process_index`` /
    ``process_count`` there, the launcher's environment here)."""
    import jax

    from followyourclick_tpu.parallel import mesh as jmesh
    from followyourclick_tpu_torch.parallel import mesh

    for rank in range(world):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", str(world))
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        for n in (0, 1, 5, 7):
            assert list(mesh.process_shard(n)) == list(
                jmesh.process_shard(n))
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    assert list(mesh.process_shard(5)) == [0, 1, 2, 3, 4]
    mesh.initialize_distributed()  # a single process: nothing to join
