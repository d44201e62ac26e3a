"""The port's file formats (``pct_tpu_torch.io``) against the JAX
package's (``pct_tpu.io``), on the same arrays made from a seed.

Each writer (txt, ASCII and binary PLY with normals, faces and
``vertex_props``, VTK with faces and scalars) writes the same bytes as
the JAX package's, and each package's reader reads the other's file to
equal arrays. ``load_points`` dispatches as the JAX package's does;
``voxel_downsample_first``, ``convert_asc_to_ply`` and
``strip_normals`` give the same arrays and bytes.
"""

import numpy as np
import pytest

import pct_tpu.io as jio
import pct_tpu.io.vtk as jvtk
import pct_tpu_torch.io as tio
import pct_tpu_torch.io.vtk as tvtk

N = 200


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20261017)
    pts = rng.standard_normal((N, 3)).astype(np.float32)
    nrm = rng.standard_normal((N, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    faces = rng.integers(0, N, size=(90, 3)).astype(np.int32)
    props = {"gaussian_curvature": rng.standard_normal(N).astype(np.float32),
             "mean_curvature": rng.standard_normal(N).astype(np.float32)}
    return pts, nrm, faces, props


def _both(tmp_path, name, write):
    """Write with each package's writer; returns (jax path, port path)."""
    pj, pt = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    write(jio, jvtk, str(pj))
    write(tio, tvtk, str(pt))
    return pj, pt


def _same_ply(a, b):
    np.testing.assert_array_equal(a.points, b.points)
    for x, y in ((a.normals, b.normals), (a.faces, b.faces)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert a.vertex_props.keys() == b.vertex_props.keys()
    for key in a.vertex_props:
        np.testing.assert_array_equal(a.vertex_props[key], b.vertex_props[key])


@pytest.mark.parametrize("with_normals", [False, True], ids=["xyz", "normals"])
def test_txt_same_bytes_and_cross_read(tmp_path, data, with_normals):
    pts, nrm, _, _ = data
    nr = nrm if with_normals else None
    pj, pt = _both(tmp_path, "c.txt",
                   lambda io, _, p: io.write_txt(p, pts, nr))
    assert pj.read_bytes() == pt.read_bytes()
    for translate in (True, False):
        for reader, path in ((tio.read_txt, pj), (jio.read_txt, pt)):
            got = reader(str(path), translate_xy_max=translate)
            want = jio.read_txt(str(pj), translate_xy_max=translate)
            np.testing.assert_array_equal(got[0], want[0])
            assert (got[1] is None) == (not with_normals)
            if with_normals:
                np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("parts", ["points", "full"])
def test_ply_same_bytes_and_cross_read(tmp_path, data, binary, parts):
    pts, nrm, faces, props = data
    kw = (dict(normals=nrm, faces=faces, vertex_props=props)
          if parts == "full" else {})
    pj, pt = _both(tmp_path, "m.ply",
                   lambda io, _, p: io.write_ply(p, pts, binary=binary, **kw))
    assert pj.read_bytes() == pt.read_bytes()
    _same_ply(tio.read_ply(str(pj)), jio.read_ply(str(pj)))
    _same_ply(jio.read_ply(str(pt)), tio.read_ply(str(pt)))
    d = tio.read_ply(str(pj))
    if binary:
        np.testing.assert_array_equal(d.points, pts)
    if parts == "full":
        np.testing.assert_array_equal(d.faces, faces)


@pytest.mark.parametrize("parts", ["points", "faces", "full"])
def test_vtk_same_bytes_and_cross_read(tmp_path, data, parts):
    pts, _, faces, props = data
    f = None if parts == "points" else faces
    sc = props if parts == "full" else None
    pj, pt = _both(tmp_path, "m.vtk",
                   lambda _, vtk, p: vtk.write_vtk(p, pts, f, sc))
    assert pj.read_bytes() == pt.read_bytes()
    for a, b in ((tvtk.read_vtk(str(pj)), jvtk.read_vtk(str(pj))),
                 (jvtk.read_vtk(str(pt)), tvtk.read_vtk(str(pt)))):
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None) == (f is None)
        if f is not None:
            np.testing.assert_array_equal(a[1], b[1])
        assert a[2].keys() == b[2].keys()
        for key in a[2]:
            np.testing.assert_array_equal(a[2][key], b[2][key])


@pytest.mark.parametrize("ext", ["ply", "asc", "txt"])
def test_load_points_dispatch(tmp_path, data, ext):
    pts, nrm, _, _ = data
    path = tmp_path / f"c.{ext}"
    if ext == "ply":
        jio.write_ply(str(path), pts, nrm)
    elif ext == "asc":
        np.savetxt(path, np.hstack([pts, nrm]))
    else:
        jio.write_txt(str(path), pts, nrm)
    got, want = tio.load_points(str(path)), jio.load_points(str(path))
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None) == (ext == "asc")
    if got[1] is not None:
        np.testing.assert_array_equal(got[1], want[1])
    if ext == "txt":      # keyword arguments reach read_txt
        np.testing.assert_array_equal(
            tio.load_points(str(path), translate_xy_max=False)[0],
            jio.load_points(str(path), translate_xy_max=False)[0])


@pytest.mark.parametrize("voxel", [0.05, 0.3, 2.0])
def test_voxel_downsample_first_matches_jax(voxel):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    got = tio.voxel_downsample_first(pts, voxel)
    np.testing.assert_array_equal(got, jio.voxel_downsample_first(pts, voxel))
    assert 0 < len(got) <= len(pts)


@pytest.mark.parametrize("voxel", [None, 0.3])
def test_convert_asc_to_ply_matches_jax(tmp_path, data, voxel):
    pts, nrm, _, _ = data
    asc = tmp_path / "s.asc"
    np.savetxt(asc, np.hstack([pts, nrm]))
    pj, pt = tmp_path / "j.ply", tmp_path / "t.ply"
    nj = jio.convert_asc_to_ply(str(asc), str(pj), voxel_size=voxel)
    nt = tio.convert_asc_to_ply(str(asc), str(pt), voxel_size=voxel)
    assert nj == nt and (voxel is not None or nt == N)
    assert pj.read_bytes() == pt.read_bytes()


def test_strip_normals_matches_jax(tmp_path, data):
    pts, nrm, faces, props = data
    src = tmp_path / "src.ply"
    jio.write_ply(str(src), pts, nrm, faces, props, binary=True)
    pj, pt = tmp_path / "j.ply", tmp_path / "t.ply"
    jio.strip_normals(str(src), str(pj))
    tio.strip_normals(str(src), str(pt))
    assert pj.read_bytes() == pt.read_bytes()
    d = tio.read_ply(str(pt))
    assert d.normals is None and d.faces is None
    # the stripped file is ASCII at %.8g, as in the JAX package, which
    # rounds some float32 coordinates by an ulp
    np.testing.assert_array_equal(d.points, jio.read_ply(str(pj)).points)
    np.testing.assert_allclose(d.points, pts, rtol=1e-7, atol=1e-7)
