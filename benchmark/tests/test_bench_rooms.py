"""The frozen room writers write the port's writers' files byte for byte
(at a small size), so the copy was faithful when it was made."""

from __future__ import annotations

import os

import pytest


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_ethz_writer_is_the_ports(tmp_path):
    from benchmark.rooms.ethz_commonroom import write_room
    from virus_nerf_tpu_torch.data.ethz_fixture import generate_ethz_fixture

    kw = dict(n_images=6, img_wh=(40, 30), n_gt_points=5000, seed=5)
    write_room(str(tmp_path / "frozen"), **kw)
    generate_ethz_fixture(str(tmp_path / "port"), **kw)
    a, b = _files(tmp_path / "frozen"), _files(tmp_path / "port")
    assert len(a) > 10 and a.keys() == b.keys()
    assert [k for k in a if a[k] != b[k]] == []


@pytest.mark.parametrize("noise", [True, False])
def test_rh2_writer_is_the_ports(tmp_path, noise):
    from benchmark.rooms.rh2_livingroom import write_room
    from virus_nerf_tpu_torch.data.rh_fixture import make_fixture

    kw = dict(n_times=4, img_wh=(40, 30), seed=9, noise=noise)
    write_room(str(tmp_path / "frozen"), **kw)
    make_fixture(str(tmp_path / "port"), **kw)
    a, b = _files(tmp_path / "frozen"), _files(tmp_path / "port")
    assert len(a) > 10 and a.keys() == b.keys()
    assert [k for k in a if a[k] != b[k]] == []
