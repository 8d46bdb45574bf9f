"""Sensor model & time synchronization (boss_map sensor layer analog).

Re-design of ``boss_map``'s sensor layer:
- `Sensor`/`SensorData` (``sensor.h:13-62``): typed sensor registry with
  topics and mounting offsets,
- `RobotConfiguration` (``robot_configuration.h:13-38``): the sensor tree
  with `sensor_offset()` kinematics,
- `SensorDataSynchronizer` (``sensor_data_synchronizer.cpp:48-151``): groups
  messages from a configured topic set into synchronized frames when every
  topic is present and all pairwise time conditions |t1 - t2| < dt hold;
  incomplete groups are flushed when a newer message for an already-buffered
  topic arrives (the reference's packet semantics).

The port's own copy of ``g2o_frontend_tpu/io/sensors.py`` (numpy only),
registered in the port's boss registry (`io/boss.py`); the two copies are
kept equal by hand.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from . import boss


@boss.register(name="PinholeImageSensor")
@dataclass
class Sensor:
    topic: str = ""
    name: str = ""
    # mounting offset as 7-vector [t, qxyzw] or 4x4
    offset: Any = None

    def offset_matrix(self) -> np.ndarray:
        if self.offset is None:
            return np.eye(4)
        off = np.asarray(self.offset)
        if off.shape == (4, 4):
            return off
        t, q = off[:3], off[3:7]
        w, x, y, z = q[3], q[0], q[1], q[2]
        n = np.sqrt(w * w + x * x + y * y + z * z) + 1e-12
        w, x, y, z = w / n, x / n, y / n, z / n
        T = np.eye(4)
        T[:3, :3] = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        T[:3, 3] = t
        return T


@boss.register(name="IMUSensor")
@dataclass
class IMUSensor(Sensor):
    """IMU sensor entry (``boss_map/imu_sensor.h:10-13``)."""


@boss.register(name="IMUData")
@dataclass
class IMUData:
    """One IMU measurement (``boss_map/imu_sensor.h:15-44``): orientation
    quaternion (xyzw) + angular velocity + linear acceleration, each with a
    3x3 covariance (row-major 9-vectors in the boss log)."""

    topic: str = ""
    timestamp: float = 0.0
    sensor: Any = None
    orientation: Any = None  # (4,) xyzw
    orientationCovariance: Any = None  # (9,)
    angularVelocity: Any = None  # (3,)
    angularVelocityCovariance: Any = None
    linearAcceleration: Any = None  # (3,)
    linearAccelerationCovariance: Any = None

    def quaternion(self) -> np.ndarray:
        q = np.asarray(self.orientation if self.orientation is not None
                       else [0.0, 0.0, 0.0, 1.0], float)
        return q / (np.linalg.norm(q) + 1e-12)


@dataclass
class SensorData:
    topic: str
    timestamp: float
    payload: Any = None


@dataclass
class RobotConfiguration:
    """Sensor tree; `sensor_offset(topic)` resolves the mounting transform
    (single-level tree — the reference chains parent frames, rarely used)."""

    sensors: dict[str, Sensor] = field(default_factory=dict)
    base_frame: str = "base_link"

    def add_sensor(self, sensor: Sensor):
        self.sensors[sensor.topic] = sensor

    def sensor_offset(self, topic: str) -> np.ndarray:
        s = self.sensors.get(topic)
        return s.offset_matrix() if s else np.eye(4)


@dataclass
class SyncCondition:
    topic1: str
    topic2: str
    dt: float = 0.05

    def eval(self, frame: dict) -> bool:
        a, b = frame.get(self.topic1), frame.get(self.topic2)
        if a is None or b is None:
            return False
        return abs(a.timestamp - b.timestamp) <= self.dt


class SensorDataSynchronizer:
    """Collect per-topic messages into synchronized frames."""

    def __init__(self, topics, conditions=None):
        self.topics = list(topics)
        self.conditions = conditions or []
        self._buffer: dict[str, SensorData] = {}
        self.dropped = 0

    def add_sync_time_condition(self, topic1, topic2, dt):
        self.conditions.append(SyncCondition(topic1, topic2, dt))

    def process(self, data: SensorData):
        """Feed one message; returns a complete frame dict or None."""
        if data.topic not in self.topics:
            return None
        if data.topic in self._buffer:
            # newer message for a buffered topic: drop the stale partial frame
            self.dropped += 1
            self._buffer = {}
        self._buffer[data.topic] = data
        if len(self._buffer) == len(self.topics) and all(
            c.eval(self._buffer) for c in self.conditions
        ):
            frame = dict(self._buffer)
            self._buffer = {}
            return frame
        return None
