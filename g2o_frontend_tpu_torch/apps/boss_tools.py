"""boss log tools: inspect / synchronize / playback, and two g2o graph tools
(counterpart of ``g2o_frontend_tpu/apps/boss_tools.py``, the boss_apps
equivalent).

Covers ``boss_apps/``: `boss_synchronizer2.cpp:114` (raw log -> synced
frames), `boss_playback.cpp:147` (timed replay), an `inspect` summary, and
the graph tools `to-graph-se2` (``toGraphSE2.cpp:38-158``) and `add-imu`
(``sensor_data/add_imu.cpp:54-130``). Host only: numpy and the port's boss
and g2o readers.

Usage:
  python -m g2o_frontend_tpu_torch.apps.boss_tools inspect LOG.boss
  python -m g2o_frontend_tpu_torch.apps.boss_tools sync LOG.boss -o SYNCED.boss \
      -t /camera/depth -t /imu --dt 0.05
  python -m g2o_frontend_tpu_torch.apps.boss_tools playback LOG.boss [--rate 2.0]
  python -m g2o_frontend_tpu_torch.apps.boss_tools to-graph-se2 GRAPH.g2o -o OUT.g2o
  python -m g2o_frontend_tpu_torch.apps.boss_tools add-imu GRAPH.g2o -o OUT.g2o [--synthesize]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter

import numpy as np

from ..io import boss
from ..io.g2o import read_g2o, se3_to_se2, write_g2o
from ..io.sensors import SensorData, SensorDataSynchronizer


def cmd_inspect(args):
    objs = boss.Deserializer(args.log).read_all()
    counts = Counter(o.get("#class", "dict") if isinstance(o, dict) else type(o).__name__ for o in objs)
    print(json.dumps({"objects": len(objs), "classes": dict(counts)}))
    return 0


def _iter_messages(objs):
    for o in objs:
        if isinstance(o, dict):
            topic = o.get("topic")
            ts = o.get("timestamp", o.get("ts"))
            if topic is not None and ts is not None:
                yield SensorData(topic, float(ts), o)


def cmd_sync(args):
    objs = boss.Deserializer(args.log).read_all()
    sync = SensorDataSynchronizer(args.topics)
    for a in args.topics[1:]:
        sync.add_sync_time_condition(args.topics[0], a, args.dt)
    n_frames = 0
    with boss.Serializer(args.output) as ser:
        for msg in _iter_messages(objs):
            frame = sync.process(msg)
            if frame:
                n_frames += 1
                ser.write({
                    "#class": "SynchronizedSensorData",
                    "topic": "sync",
                    "timestamp": max(m.timestamp for m in frame.values()),
                    "messages": [m.payload for m in frame.values()],
                })
    print(json.dumps({"frames": n_frames, "dropped": sync.dropped, "output": args.output}))
    return 0


def cmd_playback(args):
    msgs = sorted(_iter_messages(boss.Deserializer(args.log).read_all()), key=lambda m: m.timestamp)
    t_prev = None
    for m in msgs:
        if t_prev is not None and args.rate > 0:
            time.sleep(max(0.0, (m.timestamp - t_prev) / args.rate))
        t_prev = m.timestamp
        print(json.dumps({"t": m.timestamp, "topic": m.topic}))
    return 0


def cmd_to_se2(args):
    """SE3 graph -> SE2 graph with its laser data (toGraphSE2.cpp:38-158)."""
    out = se3_to_se2(read_g2o(args.graph))
    write_g2o(args.output, out)
    print(json.dumps({"vertices": len(out.se2_ids), "edges": len(out.edge_se2_ij),
                      "laser_scans": len(out.laser_scans), "output": args.output}))
    return 0


def cmd_add_imu(args):
    """IMU attachments -> EDGE_SE3_PRIOR orientation priors
    (``sensor_data/add_imu.cpp:54-130``): for each vertex with IMU data, a
    prior whose rotation is the sign-normalized IMU quaternion and whose
    translation copies the vertex estimate; information identity for the
    first vertex (the gauge), 1000 I on the rotation block otherwise.
    --synthesize first makes noise-free IMU records from the vertex
    orientations (a perfect-IMU log), for logs without IMU data."""
    log = read_g2o(args.graph)
    if args.synthesize and len(log.imu_vertex_ids) == 0:
        n = len(log.se3_ids)
        log.imu_vertex_ids = log.se3_ids.copy()
        log.imu_param = np.zeros(n, np.int64)
        log.imu_quats = log.se3_poses[:, 3:7].copy()
        log.imu_ang_vel = np.zeros((n, 3))
        log.imu_lin_acc = np.zeros((n, 3))

    id2pose = {int(v): log.se3_poses[k] for k, v in enumerate(log.se3_ids)}
    ids, meas, infos = [], [], []
    for k, vid in enumerate(log.imu_vertex_ids):
        vid = int(vid)
        if vid not in id2pose:
            continue
        q = np.asarray(log.imu_quats[k], float)
        if q[3] < 0:  # sign normalization (add_imu.cpp:103-108)
            q = -q
        z = np.zeros(7)
        z[:3] = id2pose[vid][:3]  # translation from the estimate
        z[3:7] = q
        info = np.zeros((6, 6))
        if not ids:
            info = np.eye(6)
        else:
            info[3:, 3:] = np.eye(3) * 1000.0
        ids.append(vid)
        meas.append(z)
        infos.append(info)

    log.prior_se3_ids = np.asarray(ids, np.int64)
    log.prior_se3_param = np.zeros(len(ids), np.int64)
    log.prior_se3_meas = np.asarray(meas).reshape(-1, 7)
    log.prior_se3_info = np.asarray(infos).reshape(-1, 6, 6)
    write_g2o(args.output, log)
    print(json.dumps({"priors": len(ids), "output": args.output}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("inspect")
    p.add_argument("log")
    p.set_defaults(fn=cmd_inspect)
    p = sub.add_parser("to-graph-se2")
    p.add_argument("graph")
    p.add_argument("-o", "--output", default="graphSE2.g2o")
    p.set_defaults(fn=cmd_to_se2)
    p = sub.add_parser("add-imu")
    p.add_argument("graph")
    p.add_argument("-o", "--output", default="graph_imu.g2o")
    p.add_argument("--synthesize", action="store_true")
    p.set_defaults(fn=cmd_add_imu)
    p = sub.add_parser("sync")
    p.add_argument("log")
    p.add_argument("-o", "--output", default="synced.boss")
    p.add_argument("-t", "--topics", action="append", required=True)
    p.add_argument("--dt", type=float, default=0.05)
    p.set_defaults(fn=cmd_sync)
    p = sub.add_parser("playback")
    p.add_argument("log")
    p.add_argument("--rate", type=float, default=0.0)
    p.set_defaults(fn=cmd_playback)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
