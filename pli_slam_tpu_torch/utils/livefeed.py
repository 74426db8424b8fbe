"""Live-feed front end: asynchronous sensor ingestion and stereo-inertial
synchronization (port of pli_slam_tpu.utils.livefeed; numpy and the
standard library only, as there).

`ImuGrabber` and `ImageGrabber` collect samples and stamped images pushed
from producer threads (a socket, a ROS bridge, a replay thread).
`ImageGrabber` is a bounded deque: on overflow the OLDEST frame is dropped,
so the newest frames survive (`dropped` counts them), as in the
reference's ROS wrapper. `StereoInertialSync.next_frame` pairs left and
right images whose stamps agree within `max_stereo_skew`, waits until the
IMU covers the image stamp, and returns one work item (img_l, img_r, t,
imu) per frame, or None on a timeout or after `stop()`.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np


class ImuGrabber:
    """Accumulates (stamp, gyro[3], acc[3]) samples."""

    def __init__(self, maxlen: int = 4096):
        self.buf: collections.deque = collections.deque(maxlen=maxlen)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)

    def push(self, stamp: float, gyro, acc) -> None:
        with self.cond:
            self.buf.append((float(stamp), np.asarray(gyro, np.float32),
                             np.asarray(acc, np.float32)))
            self.cond.notify_all()

    def latest_stamp(self) -> float:
        with self.lock:
            return self.buf[-1][0] if self.buf else -np.inf

    def pop_until(self, stamp: float):
        """All samples with t <= stamp, removed from the buffer."""
        out = []
        with self.lock:
            while self.buf and self.buf[0][0] <= stamp:
                out.append(self.buf.popleft())
        return out


class ImageGrabber:
    """Stamped images of one camera in a bounded deque: on overflow the
    oldest frame is dropped (counted in `dropped`) and the newest survive."""

    def __init__(self, maxlen: int = 8):
        self.buf: collections.deque = collections.deque(maxlen=maxlen)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.pushed = 0
        self.dropped = 0

    def push(self, stamp: float, img) -> None:
        with self.cond:
            if len(self.buf) == self.buf.maxlen:
                self.dropped += 1
            self.buf.append((float(stamp), img))
            self.pushed += 1
            self.cond.notify_all()

    def head_stamp(self) -> float:
        with self.lock:
            return self.buf[0][0] if self.buf else np.inf

    def pop(self):
        with self.lock:
            return self.buf.popleft() if self.buf else None

    def drop_older_than(self, stamp: float) -> int:
        n = 0
        with self.lock:
            while self.buf and self.buf[0][0] < stamp:
                self.buf.popleft()
                n += 1
        return n


class StereoInertialSync:
    """Pairs left / right frames with the IMU span since the last frame;
    `next_frame` blocks up to `timeout` for a complete item."""

    def __init__(self, max_stereo_skew: float = 0.01, use_imu: bool = True):
        self.left = ImageGrabber()
        self.right = ImageGrabber()
        self.imu = ImuGrabber()
        self.max_skew = max_stereo_skew
        self.use_imu = use_imu
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()
        with self.left.cond:
            self.left.cond.notify_all()

    def next_frame(self, timeout: float = 1.0):
        """Returns dict(img_l, img_r, t, imu) or None on timeout/stop."""
        t_end = time.time() + timeout
        while not self._stop.is_set():
            tl, tr = self.left.head_stamp(), self.right.head_stamp()
            # drop the older stream head until the pair agrees
            if np.isfinite(tl) and np.isfinite(tr):
                if tl < tr - self.max_skew:
                    self.left.pop()
                    continue
                if tr < tl - self.max_skew:
                    self.right.pop()
                    continue
                stamp = min(tl, tr)
                # the IMU must cover the image stamp before tracking
                if self.use_imu and self.imu.latest_stamp() < stamp:
                    if time.time() >= t_end:
                        return None
                    with self.imu.cond:
                        self.imu.cond.wait(0.005)
                    continue
                _, img_l = self.left.pop()
                _, img_r = self.right.pop()
                imu_batch = None
                if self.use_imu:
                    samples = self.imu.pop_until(stamp)
                    if samples:
                        imu_batch = {
                            "stamps": np.asarray([s for s, _, _ in samples]),
                            "gyro": np.stack([g for _, g, _ in samples]),
                            "acc": np.stack([a for _, _, a in samples]),
                        }
                return {"img_l": img_l, "img_r": img_r, "t": stamp, "imu": imu_batch}
            if time.time() >= t_end:
                return None
            with self.left.cond:
                self.left.cond.wait(0.005)
        return None
