"""ctypes adapter for the native C++ vectorised env pool (counterpart of
stoix_tpu/envs/cvec.py: `CVecPool`, `CVecEnvFactory`, `CVecCartPole`).

`envs/native/cvec.cpp` is a byte-for-byte copy of the JAX package's source:
CartPole-v1, Pendulum-v1 (continuous torque, float actions through
`cvec_step_cont`), the four MinAtar games (10x10x4) and Breakout-atari
(84x84x4 frame-stacked pixels). A batch of envs steps in one C call with
auto-reset and episode metrics; no Python loop runs over envs.

The library builds at first use, never at import, with `g++ -O3 -shared
-fPIC` into the git-ignored `stoix_tpu_torch/_build/`, named by the hash of
the source and the flags. Several actor threads, and several processes, may
build it at once: a lock serialises this process's threads, and each build
writes a temporary file that is renamed into place, so a reader never loads
a half-written library. The pool's outputs are host tensors (CPU torch
tensors over its numpy buffers, copied each step).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.factory import EnvFactory
from stoix_tpu_torch.envs.types import Observation, TimeStep

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE_DIR, "envs", "native", "cvec.cpp")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300
_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libcvec_{digest}.so")


def ensure_built() -> str:
    """The library's path, built first if it is not there."""
    path = library_path()
    with _BUILD_LOCK:
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                               capture_output=True, timeout=BUILD_TIMEOUT_S)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return path


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(ensure_built())
    lib.cvec_create.restype = ctypes.c_void_p
    lib.cvec_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.cvec_reset.argtypes = [ctypes.c_void_p, f32p]
    lib.cvec_step.argtypes = [ctypes.c_void_p, i32p, f32p, f32p, f32p, u8p, u8p, f32p, i32p]
    lib.cvec_obs_dim.argtypes = [ctypes.c_void_p]
    lib.cvec_obs_dim.restype = ctypes.c_int
    lib.cvec_obs_shape.argtypes = [ctypes.c_void_p, i32p]
    lib.cvec_num_actions.argtypes = [ctypes.c_void_p]
    lib.cvec_num_actions.restype = ctypes.c_int
    lib.cvec_action_dim.argtypes = [ctypes.c_void_p]
    lib.cvec_action_dim.restype = ctypes.c_int
    lib.cvec_action_bounds.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_float)]
    lib.cvec_step_cont.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, f32p, u8p, u8p, f32p,
                                   i32p]
    lib.cvec_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def host_tensor(x: np.ndarray) -> torch.Tensor:
    """A host tensor holding a copy of `x` (the pool's buffers are reused)."""
    return torch.from_numpy(np.ascontiguousarray(x).copy())


class CVecPool:
    """Stateful Sebulba env backed by the native pool: actions in (a tensor
    or an array, on any device), a TimeStep of host tensors out."""

    def __init__(self, task: str, num_envs: int, seed: int, max_steps: int = 500):
        self._lib = load_library()
        self._handle = self._lib.cvec_create(task.encode(), num_envs, max_steps, seed)
        if not self._handle:
            raise ValueError(f"Unknown native pool game '{task}'")
        self._task = task
        self._n = num_envs
        shape3 = np.zeros((3,), np.int32)
        self._lib.cvec_obs_shape(self._handle, shape3)
        # (d, 1, 1) encodes a flat d-vector; anything else is an image.
        self._obs_shape: Tuple[int, ...] = (
            (int(shape3[0]),) if shape3[1] == 1 and shape3[2] == 1
            else tuple(int(s) for s in shape3))
        self._num_actions = int(self._lib.cvec_num_actions(self._handle))
        # action_dim > 0 marks a continuous game (float [n, action_dim]
        # actions through cvec_step_cont; a Box with the game's bounds).
        self._action_dim = int(self._lib.cvec_action_dim(self._handle))
        lo, hi = ctypes.c_float(), ctypes.c_float()
        self._lib.cvec_action_bounds(self._handle, ctypes.byref(lo), ctypes.byref(hi))
        self._action_bounds = (float(lo.value), float(hi.value))
        dim = int(self._lib.cvec_obs_dim(self._handle))
        self._obs = np.zeros((num_envs, dim), np.float32)
        self._next_obs = np.zeros((num_envs, dim), np.float32)
        self._reward = np.zeros((num_envs,), np.float32)
        self._done = np.zeros((num_envs,), np.uint8)
        self._trunc = np.zeros((num_envs,), np.uint8)
        self._ep_return = np.zeros((num_envs,), np.float32)
        self._ep_length = np.zeros((num_envs,), np.int32)

    @property
    def num_envs(self) -> int:
        return self._n

    @property
    def num_actions(self) -> int:
        return self._num_actions

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array(self._obs_shape, torch.float32),
            action_mask=spaces.Array((self._num_actions,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def observation_value(self) -> Observation:
        return spaces.tree_generate_value(self.observation_space())

    def action_space(self):
        if self._action_dim > 0:
            lo, hi = self._action_bounds
            return spaces.Box(low=lo, high=hi, shape=(self._action_dim,))
        return spaces.Discrete(self._num_actions)

    def _observation(self, view: np.ndarray, counts: np.ndarray) -> Observation:
        return Observation(
            agent_view=host_tensor(view.reshape((self._n,) + self._obs_shape)),
            action_mask=torch.ones((self._n, self._num_actions), dtype=torch.float32),
            step_count=host_tensor(counts.astype(np.int32)),
        )

    def _timestep(self, first: bool) -> TimeStep:
        done = self._done.astype(bool)
        trunc = self._trunc.astype(bool)
        last = done | trunc
        counts = np.where(last, 0, self._ep_length)
        step_type = (np.zeros((self._n,), np.int8) if first
                     else np.where(last, np.int8(2), np.int8(1)).astype(np.int8))
        return TimeStep(
            step_type=host_tensor(step_type),
            reward=host_tensor(self._reward),
            discount=host_tensor(np.where(done, 0.0, 1.0).astype(np.float32)),
            observation=self._observation(self._obs, counts),
            extras={
                "next_obs": self._observation(self._next_obs, self._ep_length),
                "truncation": host_tensor(trunc),
                "episode_metrics": {
                    "episode_return": host_tensor(self._ep_return),
                    "episode_length": host_tensor(self._ep_length),
                    "is_terminal_step": host_tensor(last),
                },
            },
        )

    def reset(self, *, seed: Optional[int] = None) -> TimeStep:
        del seed  # seeding is fixed at construction (thread-unique via the factory)
        self._lib.cvec_reset(self._handle, self._obs)
        self._reward[:] = 0
        self._done[:] = 0
        self._trunc[:] = 0
        self._ep_return[:] = 0
        self._ep_length[:] = 0
        self._next_obs[:] = self._obs
        return self._timestep(first=True)

    def step(self, action: Any) -> TimeStep:
        if isinstance(action, torch.Tensor):
            action = action.detach().cpu().numpy()
        if self._action_dim > 0:
            actions = np.ascontiguousarray(
                np.asarray(action, np.float32).reshape(self._n, self._action_dim))
            self._lib.cvec_step_cont(self._handle, actions, self._obs, self._next_obs,
                                     self._reward, self._done, self._trunc, self._ep_return,
                                     self._ep_length)
        else:
            actions = np.ascontiguousarray(np.asarray(action, np.int32))
            self._lib.cvec_step(self._handle, actions, self._obs, self._next_obs, self._reward,
                                self._done, self._trunc, self._ep_return, self._ep_length)
        return self._timestep(first=False)

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.cvec_destroy(self._handle)
            self._handle = None


class CVecEnvFactory(EnvFactory):
    """Factory for the native pool; the scenario name selects the game."""

    def __call__(self, num_envs: int) -> CVecPool:
        seed = self._next_seed(num_envs)
        return CVecPool(self._task_id, num_envs, seed, **self._kwargs)


class CVecCartPole(CVecPool):
    """The pool's CartPole-v1."""

    def __init__(self, num_envs: int, seed: int, max_steps: int = 500):
        super().__init__("CartPole-v1", num_envs, seed, max_steps)
