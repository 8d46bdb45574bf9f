"""Reader/writer for .g2o text logs, including the reference's custom records.

The reference's evaluation data (its `datasets/2D/`) uses:

- ``VERTEX_SE2 id x y theta``
- ``VERTEX_XY id x y``                         (landmarks)
- ``EDGE_SE2 i j dx dy dth  i11 i12 i13 i22 i23 i33``  (upper-tri info)
- ``EDGE_SE2_XY i j dx dy  i11 i12 i22``
- ``VERTEX_SE3:QUAT id x y z qx qy qz qw``
- ``EDGE_SE3:QUAT i j x y z qx qy qz qw  <21 upper-tri info>``
- ``FIX id``
- ``PARAMS_SE3OFFSET id x y z qx qy qz qw``
- ``LASER_ROBOT_DATA paramIndex firstBeamAngle fov res maxRange accuracy
  remissionMode N <N ranges> [M <M remissions>] ...``  — a laser scan
  attached to the most recent vertex (reference:
  ``sensor_data/laser_robot_data.cpp`` read/write, fields per
  ``laser_robot_data.h:40-100``).
- ``DATA_FEATURE_POINTXY tag dim x y i11 i12 i22`` — a 2D feature observation
  attached to the most recent vertex (reference: ``data/feature_data.h``;
  used by ``slam/tracker_test.cpp`` for the *noassoc* datasets).

Output is a plain-Python `G2OLog` of numpy arrays (host-side; conversion to
device arrays happens in `graph.store`).

The port's own copy of ``g2o_frontend_tpu/io/g2o.py`` (numpy only): the
port imports nothing of the JAX package, so the two copies are kept equal
by hand. Its native path calls the port's loader (`native/__init__.py`),
which builds ``native/fastg2o.cpp`` into ``_build/`` and raises when the
build fails; file-like inputs and logs with ``EDGE_SE3_PRIOR`` or
``IMU_DATA`` records take the Python parser.
"""
from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass, field

import numpy as np

__all__ = ["G2OLog", "LaserScan", "read_g2o", "write_g2o"]


@dataclass
class LaserScan:
    """One 2D laser scan attached to a pose vertex."""

    vertex_id: int
    first_beam_angle: float
    fov: float
    angular_step: float
    max_range: float
    accuracy: float
    ranges: np.ndarray  # (N,) float32
    remissions: np.ndarray | None = None
    # laser pose on the robot (x, y, theta), from PARAMS offset if present
    offset: tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def angles(self) -> np.ndarray:
        n = len(self.ranges)
        return self.first_beam_angle + self.angular_step * np.arange(n, dtype=np.float32)


@dataclass
class G2OLog:
    """Parsed contents of a .g2o file as struct-of-arrays."""

    # SE2 pose vertices
    se2_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    se2_poses: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))
    # XY landmark vertices
    xy_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    xy_points: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float64))
    # SE3 pose vertices (x y z qx qy qz qw)
    se3_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    se3_poses: np.ndarray = field(default_factory=lambda: np.zeros((0, 7), np.float64))
    # SE2-SE2 edges
    edge_se2_ij: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    edge_se2_meas: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))
    edge_se2_info: np.ndarray = field(default_factory=lambda: np.zeros((0, 3, 3), np.float64))
    # SE2-XY edges
    edge_se2xy_ij: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    edge_se2xy_meas: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float64))
    edge_se2xy_info: np.ndarray = field(default_factory=lambda: np.zeros((0, 2, 2), np.float64))
    # SE3-SE3 edges
    edge_se3_ij: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    edge_se3_meas: np.ndarray = field(default_factory=lambda: np.zeros((0, 7), np.float64))
    edge_se3_info: np.ndarray = field(default_factory=lambda: np.zeros((0, 6, 6), np.float64))
    # Line-SLAM records (g2o_line_addons / line_alignment graphs):
    # VERTEX_LINE2D id theta rho p1_id p2_id
    line2d_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    line2d_params: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float64))
    line2d_endpoints: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    # VERTEX_EXTREME_XY id x y density (vertex_extreme_point_xy.h:38)
    extreme_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    extreme_points: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float64))
    extreme_density: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    # EDGE_SE2_LINE2D i j dtheta drho <3 upper-tri info>
    edge_se2line_ij: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    edge_se2line_meas: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float64))
    edge_se2line_info: np.ndarray = field(default_factory=lambda: np.zeros((0, 2, 2), np.float64))
    # EDGE_LINE2D_POINTXY line_id point_id measurement info
    edge_linexy_ij: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    edge_linexy_meas: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    edge_linexy_info: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    # EDGE_SE3_PRIOR id paramId meas7 <21 upper-tri info> (g2o slam3d_addons;
    # produced by the add_imu app, ``sensor_data/add_imu.cpp:96-121``)
    prior_se3_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    prior_se3_param: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    prior_se3_meas: np.ndarray = field(default_factory=lambda: np.zeros((0, 7), np.float64))
    prior_se3_info: np.ndarray = field(default_factory=lambda: np.zeros((0, 6, 6), np.float64))
    # IMU_DATA attachments (``sensor_data/imu_data.cpp:62-127``): per record
    # (vertex_id, param) + quaternion/angular-velocity/linear-acceleration
    imu_vertex_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    imu_param: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    imu_quats: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float64))  # xyzw
    imu_ang_vel: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))
    imu_lin_acc: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))
    # Fixed vertex ids (gauge)
    fixed_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # Attached data
    laser_scans: list[LaserScan] = field(default_factory=list)
    # feature observations: (vertex_id, x, y, i11, i12, i22)
    features: np.ndarray = field(default_factory=lambda: np.zeros((0, 6), np.float64))
    # params: id -> 7-vector offset
    params_se3_offset: dict[int, np.ndarray] = field(default_factory=dict)


def _sym_from_upper(vals, d):
    """Upper-triangular row-major values -> symmetric (d,d) matrix."""
    M = np.zeros((d, d))
    k = 0
    for r in range(d):
        for c in range(r, d):
            M[r, c] = vals[k]
            M[c, r] = vals[k]
            k += 1
    return M


def read_g2o(path_or_file, native: bool = True) -> G2OLog:
    """Parse a .g2o file (transparently handles .gz).

    Uses the C++ tokenizer (`native/fastg2o.cpp`) when available — the
    framework's native IO path, ~10x the pure-Python parser — and falls back
    to Python transparently (also used for file-like inputs)."""
    if native and not hasattr(path_or_file, "read"):
        log = _read_g2o_native(str(path_or_file))
        if log is not None:
            return log
    if hasattr(path_or_file, "read"):
        fh = path_or_file
        close = False
    else:
        path = str(path_or_file)
        fh = gzip.open(path, "rt") if path.endswith(".gz") else open(path)
        close = True

    se2_ids, se2_poses = [], []
    xy_ids, xy_points = [], []
    se3_ids, se3_poses = [], []
    e2_ij, e2_z, e2_w = [], [], []
    exy_ij, exy_z, exy_w = [], [], []
    e3_ij, e3_z, e3_w = [], [], []
    l2_ids, l2_par, l2_ep = [], [], []
    ex_ids, ex_pts, ex_den = [], [], []
    esl_ij, esl_z, esl_w = [], [], []
    elx_ij, elx_z, elx_w = [], [], []
    pr_ids, pr_param, pr_z, pr_w = [], [], [], []
    imu_vid, imu_par, imu_q, imu_w, imu_a = [], [], [], [], []
    fixed = []
    scans: list[LaserScan] = []
    feats = []
    params: dict[int, np.ndarray] = {}
    last_vertex = -1

    try:
        for line in fh:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            tag = tok[0]
            if tag == "VERTEX_SE2":
                last_vertex = int(tok[1])
                se2_ids.append(last_vertex)
                se2_poses.append([float(tok[2]), float(tok[3]), float(tok[4])])
            elif tag == "VERTEX_XY":
                last_vertex = int(tok[1])
                xy_ids.append(last_vertex)
                xy_points.append([float(tok[2]), float(tok[3])])
            elif tag in ("VERTEX_SE3:QUAT", "VERTEX_SE3"):
                last_vertex = int(tok[1])
                se3_ids.append(last_vertex)
                se3_poses.append([float(v) for v in tok[2:9]])
            elif tag == "EDGE_SE2":
                e2_ij.append([int(tok[1]), int(tok[2])])
                e2_z.append([float(tok[3]), float(tok[4]), float(tok[5])])
                e2_w.append(_sym_from_upper([float(v) for v in tok[6:12]], 3))
            elif tag == "EDGE_SE2_XY":
                exy_ij.append([int(tok[1]), int(tok[2])])
                exy_z.append([float(tok[3]), float(tok[4])])
                exy_w.append(_sym_from_upper([float(v) for v in tok[5:8]], 2))
            elif tag in ("EDGE_SE3:QUAT", "EDGE_SE3"):
                e3_ij.append([int(tok[1]), int(tok[2])])
                e3_z.append([float(v) for v in tok[3:10]])
                e3_w.append(_sym_from_upper([float(v) for v in tok[10:31]], 6))
            elif tag == "VERTEX_LINE2D":
                last_vertex = int(tok[1])
                l2_ids.append(last_vertex)
                l2_par.append([float(tok[2]), float(tok[3])])
                l2_ep.append(
                    [int(tok[4]), int(tok[5])] if len(tok) >= 6 else [-1, -1]
                )
            elif tag == "VERTEX_EXTREME_XY":
                last_vertex = int(tok[1])
                ex_ids.append(last_vertex)
                ex_pts.append([float(tok[2]), float(tok[3])])
                ex_den.append(float(tok[4]) if len(tok) > 4 else 1.0)
            elif tag == "EDGE_SE2_LINE2D":
                esl_ij.append([int(tok[1]), int(tok[2])])
                esl_z.append([float(tok[3]), float(tok[4])])
                esl_w.append(_sym_from_upper([float(v) for v in tok[5:8]], 2))
            elif tag == "EDGE_LINE2D_POINTXY":
                elx_ij.append([int(tok[1]), int(tok[2])])
                elx_z.append(float(tok[3]))
                elx_w.append(float(tok[4]))
            elif tag == "EDGE_SE3_PRIOR":
                pr_ids.append(int(tok[1]))
                pr_param.append(int(tok[2]))
                pr_z.append([float(v) for v in tok[3:10]])
                pr_w.append(_sym_from_upper([float(v) for v in tok[10:31]], 6))
            elif tag == "IMU_DATA":
                # paramIdx qx qy qz qw, then size-prefixed vectors:
                # 9 orient-cov, 3 ang-vel, 9 cov, 3 lin-acc, 9 cov
                # (imu_data.cpp:62-127)
                imu_vid.append(last_vertex)
                imu_par.append(int(tok[1]))
                imu_q.append([float(v) for v in tok[2:6]])
                k = 6
                vecs = []
                while k < len(tok) and len(vecs) < 5:
                    m = int(float(tok[k]))
                    vecs.append([float(v) for v in tok[k + 1 : k + 1 + m]])
                    k += 1 + m
                imu_w.append(vecs[1] if len(vecs) > 1 else [0.0] * 3)
                imu_a.append(vecs[3] if len(vecs) > 3 else [0.0] * 3)
            elif tag == "FIX":
                fixed.extend(int(v) for v in tok[1:])
            elif tag == "PARAMS_SE3OFFSET":
                params[int(tok[1])] = np.array([float(v) for v in tok[2:9]])
            elif tag == "LASER_ROBOT_DATA":
                # paramIndex firstBeamAngle fov res maxRange accuracy remissionMode
                pidx = int(tok[1])
                fba, fov, res = float(tok[2]), float(tok[3]), float(tok[4])
                max_range, acc = float(tok[5]), float(tok[6])
                n = int(tok[8])
                ranges = np.array([float(v) for v in tok[9 : 9 + n]], np.float32)
                rem = None
                k = 9 + n
                if k < len(tok):
                    try:
                        m = int(tok[k])
                        if m > 0 and k + 1 + m <= len(tok):
                            rem = np.array(
                                [float(v) for v in tok[k + 1 : k + 1 + m]], np.float32
                            )
                    except ValueError:
                        pass
                off = (0.0, 0.0, 0.0)
                if pidx in params:
                    p = params[pidx]
                    # use yaw of the 3D offset quaternion
                    qx, qy, qz, qw = p[3:7]
                    yaw = np.arctan2(
                        2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz)
                    )
                    off = (float(p[0]), float(p[1]), float(yaw))
                scans.append(
                    LaserScan(last_vertex, fba, fov, res, max_range, acc, ranges, rem, off)
                )
            elif tag == "DATA_FEATURE_POINTXY":
                # tag dim x y i11 i12 i22  (attached to last vertex)
                feats.append(
                    [
                        last_vertex,
                        float(tok[3]),
                        float(tok[4]),
                        float(tok[5]),
                        float(tok[6]),
                        float(tok[7]),
                    ]
                )
    finally:
        if close:
            fh.close()

    return G2OLog(
        se2_ids=np.asarray(se2_ids, np.int64),
        se2_poses=np.asarray(se2_poses, np.float64).reshape(-1, 3),
        xy_ids=np.asarray(xy_ids, np.int64),
        xy_points=np.asarray(xy_points, np.float64).reshape(-1, 2),
        se3_ids=np.asarray(se3_ids, np.int64),
        se3_poses=np.asarray(se3_poses, np.float64).reshape(-1, 7),
        edge_se2_ij=np.asarray(e2_ij, np.int64).reshape(-1, 2),
        edge_se2_meas=np.asarray(e2_z, np.float64).reshape(-1, 3),
        edge_se2_info=np.asarray(e2_w, np.float64).reshape(-1, 3, 3),
        edge_se2xy_ij=np.asarray(exy_ij, np.int64).reshape(-1, 2),
        edge_se2xy_meas=np.asarray(exy_z, np.float64).reshape(-1, 2),
        edge_se2xy_info=np.asarray(exy_w, np.float64).reshape(-1, 2, 2),
        edge_se3_ij=np.asarray(e3_ij, np.int64).reshape(-1, 2),
        edge_se3_meas=np.asarray(e3_z, np.float64).reshape(-1, 7),
        edge_se3_info=np.asarray(e3_w, np.float64).reshape(-1, 6, 6),
        line2d_ids=np.asarray(l2_ids, np.int64),
        line2d_params=np.asarray(l2_par, np.float64).reshape(-1, 2),
        line2d_endpoints=np.asarray(l2_ep, np.int64).reshape(-1, 2),
        extreme_ids=np.asarray(ex_ids, np.int64),
        extreme_points=np.asarray(ex_pts, np.float64).reshape(-1, 2),
        extreme_density=np.asarray(ex_den, np.float64),
        edge_se2line_ij=np.asarray(esl_ij, np.int64).reshape(-1, 2),
        edge_se2line_meas=np.asarray(esl_z, np.float64).reshape(-1, 2),
        edge_se2line_info=np.asarray(esl_w, np.float64).reshape(-1, 2, 2),
        edge_linexy_ij=np.asarray(elx_ij, np.int64).reshape(-1, 2),
        edge_linexy_meas=np.asarray(elx_z, np.float64),
        edge_linexy_info=np.asarray(elx_w, np.float64),
        prior_se3_ids=np.asarray(pr_ids, np.int64),
        prior_se3_param=np.asarray(pr_param, np.int64),
        prior_se3_meas=np.asarray(pr_z, np.float64).reshape(-1, 7),
        prior_se3_info=np.asarray(pr_w, np.float64).reshape(-1, 6, 6),
        imu_vertex_ids=np.asarray(imu_vid, np.int64),
        imu_param=np.asarray(imu_par, np.int64),
        imu_quats=np.asarray(imu_q, np.float64).reshape(-1, 4),
        imu_ang_vel=np.asarray(imu_w, np.float64).reshape(-1, 3),
        imu_lin_acc=np.asarray(imu_a, np.float64).reshape(-1, 3),
        fixed_ids=np.asarray(sorted(set(fixed)), np.int64),
        laser_scans=scans,
        features=np.asarray(feats, np.float64).reshape(-1, 6),
        params_se3_offset=params,
    )


def _read_g2o_native(path: str) -> G2OLog | None:
    """Build a G2OLog from the native parser's packed tables (or None)."""
    try:
        from ..native import parse_g2o_bytes
    except Exception:
        return None
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rb") as fh:
                data = fh.read()
        else:
            with open(path, "rb") as fh:
                data = fh.read()
    except OSError:
        return None
    if b"EDGE_SE3_PRIOR" in data or b"IMU_DATA" in data:
        return None  # prior/IMU records: only the Python parser knows them
    t = parse_g2o_bytes(data)
    if t is None:
        return None

    def sym(rows, d):
        out = np.zeros((len(rows), d, d))
        k = 0
        iu = np.triu_indices(d)
        out[:, iu[0], iu[1]] = rows
        out[:, iu[1], iu[0]] = rows
        return out

    params = {
        int(r[0]): r[1:8].copy() for r in t["params"]
    }
    scans = []
    flat = t["laser_ranges"].reshape(-1)
    for r in t["laser_meta"]:
        vid, pidx = int(r[0]), int(r[1])
        off, n = int(r[7]), int(r[8])
        offset = (0.0, 0.0, 0.0)
        if pidx in params:
            p = params[pidx]
            qx, qy, qz, qw = p[3:7]
            yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
            offset = (float(p[0]), float(p[1]), float(yaw))
        scans.append(
            LaserScan(
                vid, float(r[2]), float(r[3]), float(r[4]), float(r[5]),
                float(r[6]), flat[off : off + n].astype(np.float32), None, offset,
            )
        )
    feats = t["features"]
    return G2OLog(
        se2_ids=t["vertex_se2"][:, 0].astype(np.int64),
        se2_poses=t["vertex_se2"][:, 1:4],
        xy_ids=t["vertex_xy"][:, 0].astype(np.int64),
        xy_points=t["vertex_xy"][:, 1:3],
        se3_ids=t["vertex_se3"][:, 0].astype(np.int64),
        se3_poses=t["vertex_se3"][:, 1:8],
        edge_se2_ij=t["edge_se2"][:, 0:2].astype(np.int64),
        edge_se2_meas=t["edge_se2"][:, 2:5],
        edge_se2_info=sym(t["edge_se2"][:, 5:11], 3),
        edge_se2xy_ij=t["edge_se2_xy"][:, 0:2].astype(np.int64),
        edge_se2xy_meas=t["edge_se2_xy"][:, 2:4],
        edge_se2xy_info=sym(t["edge_se2_xy"][:, 4:7], 2),
        edge_se3_ij=t["edge_se3"][:, 0:2].astype(np.int64),
        edge_se3_meas=t["edge_se3"][:, 2:9],
        edge_se3_info=sym(t["edge_se3"][:, 9:30], 6),
        line2d_ids=t["vertex_line2d"][:, 0].astype(np.int64),
        line2d_params=t["vertex_line2d"][:, 1:3],
        line2d_endpoints=t["vertex_line2d"][:, 3:5].astype(np.int64),
        extreme_ids=t["vertex_extreme"][:, 0].astype(np.int64),
        extreme_points=t["vertex_extreme"][:, 1:3],
        extreme_density=t["vertex_extreme"][:, 3],
        edge_se2line_ij=t["edge_se2_line2d"][:, 0:2].astype(np.int64),
        edge_se2line_meas=t["edge_se2_line2d"][:, 2:4],
        edge_se2line_info=sym(t["edge_se2_line2d"][:, 4:7], 2),
        edge_linexy_ij=t["edge_line2d_xy"][:, 0:2].astype(np.int64),
        edge_linexy_meas=t["edge_line2d_xy"][:, 2],
        edge_linexy_info=t["edge_line2d_xy"][:, 3],
        fixed_ids=np.asarray(
            sorted({int(v) for v in t["fixed"].reshape(-1)}), np.int64
        ),
        laser_scans=scans,
        features=feats.reshape(-1, 6),
        params_se3_offset=params,
    )


def se3_to_se2(log: G2OLog) -> G2OLog:
    """Flatten an SE3 pose graph to SE2, keeping attached laser data.

    The ``toGraphSE2`` app (``line_extraction/toGraphSE2.cpp:38-158``):
    every VertexSE3 becomes a VertexSE2 at (x, y, yaw), every EdgeSE3
    becomes an EdgeSE2 whose measurement is recomputed from the converted
    states (`setMeasurementFromState`, ``toGraphSE2.cpp:150``) with identity
    information (the reference's ``info.setIdentity()*1000`` discards the
    scaling — identity is its actual behavior, ``toGraphSE2.cpp:155``).
    """
    n = len(log.se3_ids)
    poses2 = np.zeros((n, 3))
    for i in range(n):
        x, y, _, qx, qy, qz, qw = log.se3_poses[i]
        # yaw of the rotation: atan2(R10, R00) (iso3toSE_2d)
        r10 = 2.0 * (qx * qy + qw * qz)
        r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
        poses2[i] = (x, y, np.arctan2(r10, r00))
    id_to_row = {int(v): k for k, v in enumerate(log.se3_ids)}

    m = len(log.edge_se3_ij)
    e_ij = np.zeros((m, 2), np.int64)
    e_z = np.zeros((m, 3))
    e_w = np.tile(np.eye(3), (m, 1, 1))
    for k in range(m):
        i, j = (int(v) for v in log.edge_se3_ij[k])
        e_ij[k] = (i, j)
        xi, yi, ti = poses2[id_to_row[i]]
        xj, yj, tj = poses2[id_to_row[j]]
        c, s = np.cos(ti), np.sin(ti)
        dx, dy = xj - xi, yj - yi
        dth = tj - ti
        e_z[k] = (c * dx + s * dy, -s * dx + c * dy,
                  np.arctan2(np.sin(dth), np.cos(dth)))
    return G2OLog(
        se2_ids=log.se3_ids.copy(),
        se2_poses=poses2,
        edge_se2_ij=e_ij,
        edge_se2_meas=e_z,
        edge_se2_info=e_w,
        fixed_ids=log.fixed_ids.copy(),
        laser_scans=list(log.laser_scans),
        features=log.features.copy(),
        params_se3_offset=dict(log.params_se3_offset),
    )


def _upper(M):
    d = M.shape[0]
    return " ".join(repr(float(M[r, c])) for r in range(d) for c in range(r, d))


def write_g2o(path, log: G2OLog) -> None:
    """Write poses/landmarks/edges back out (data records are not re-emitted)."""
    buf = _io.StringIO()
    for i, vid in enumerate(log.se2_ids):
        p = [float(v) for v in log.se2_poses[i]]
        buf.write(f"VERTEX_SE2 {int(vid)} {p[0]!r} {p[1]!r} {p[2]!r}\n")
    for i, vid in enumerate(log.xy_ids):
        p = [float(v) for v in log.xy_points[i]]
        buf.write(f"VERTEX_XY {int(vid)} {p[0]!r} {p[1]!r}\n")
    for i, vid in enumerate(log.se3_ids):
        p = log.se3_poses[i]
        buf.write(
            "VERTEX_SE3:QUAT %d %s\n" % (int(vid), " ".join(repr(float(v)) for v in p))
        )
    for i, vid in enumerate(log.extreme_ids):
        p = [float(v) for v in log.extreme_points[i]]
        d = float(log.extreme_density[i])
        buf.write(f"VERTEX_EXTREME_XY {int(vid)} {p[0]!r} {p[1]!r} {d!r}\n")
    for i, vid in enumerate(log.line2d_ids):
        th, rho = (float(v) for v in log.line2d_params[i])
        p1, p2 = (int(v) for v in log.line2d_endpoints[i])
        buf.write(f"VERTEX_LINE2D {int(vid)} {th!r} {rho!r} {p1} {p2}\n")
    for vid in log.fixed_ids:
        buf.write(f"FIX {int(vid)}\n")
    for k in range(len(log.edge_se2_ij)):
        i, j = log.edge_se2_ij[k]
        z = [float(v) for v in log.edge_se2_meas[k]]
        buf.write(
            f"EDGE_SE2 {int(i)} {int(j)} {z[0]!r} {z[1]!r} {z[2]!r} "
            f"{_upper(log.edge_se2_info[k])}\n"
        )
    for k in range(len(log.edge_se2xy_ij)):
        i, j = log.edge_se2xy_ij[k]
        z = [float(v) for v in log.edge_se2xy_meas[k]]
        buf.write(
            f"EDGE_SE2_XY {int(i)} {int(j)} {z[0]!r} {z[1]!r} "
            f"{_upper(log.edge_se2xy_info[k])}\n"
        )
    for k in range(len(log.edge_se2line_ij)):
        i, j = log.edge_se2line_ij[k]
        z = [float(v) for v in log.edge_se2line_meas[k]]
        buf.write(
            f"EDGE_SE2_LINE2D {int(i)} {int(j)} {z[0]!r} {z[1]!r} "
            f"{_upper(log.edge_se2line_info[k])}\n"
        )
    for k in range(len(log.edge_linexy_ij)):
        i, j = log.edge_linexy_ij[k]
        buf.write(
            f"EDGE_LINE2D_POINTXY {int(i)} {int(j)} "
            f"{float(log.edge_linexy_meas[k])!r} {float(log.edge_linexy_info[k])!r}\n"
        )
    for k in range(len(log.prior_se3_ids)):
        z = log.prior_se3_meas[k]
        buf.write(
            "EDGE_SE3_PRIOR %d %d %s %s\n"
            % (
                int(log.prior_se3_ids[k]),
                int(log.prior_se3_param[k]),
                " ".join(repr(float(v)) for v in z),
                _upper(log.prior_se3_info[k]),
            )
        )
    for k in range(len(log.edge_se3_ij)):
        i, j = log.edge_se3_ij[k]
        z = log.edge_se3_meas[k]
        buf.write(
            "EDGE_SE3:QUAT %d %d %s %s\n"
            % (
                int(i),
                int(j),
                " ".join(repr(float(v)) for v in z),
                _upper(log.edge_se3_info[k]),
            )
        )
    with open(path, "w") as fh:
        fh.write(buf.getvalue())
