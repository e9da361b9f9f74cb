"""Per-frame input actions.

The reference polls Win32 key state every frame (GetAsyncKeyState,
scene.cpp:142-163 and 689-756). Here input arrives as a plain pytree of
held-key values so the same pure step function serves interactive windows,
scripted benchmark drivers, and tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np


class Action(NamedTuple):
    """One frame of input. Integer fields are -1/0/+1 'axis' values."""

    move_side: jax.Array     # D - A            (scene.cpp:149)
    move_forward: jax.Array  # W - S            (scene.cpp:151)
    move_up: jax.Array       # Q - E            (scene.cpp:153)
    run: jax.Array           # bool: shift held (scene.cpp:156)
    mouse_dx: jax.Array      # pixels since last frame (mouseMotion)
    mouse_dy: jax.Array
    time_control: jax.Array  # RIGHT - LEFT     (scene.cpp:691)
    set_play: jax.Array      # bool: P held     (scene.cpp:700)
    set_pause: jax.Array     # bool: O held     (scene.cpp:703)
    sea_control: jax.Array   # UP - DOWN        (scene.cpp:708)
    time_preset: jax.Array   # int: -1 none, 0..3 = keys 1/2/3/4 (scene.cpp:713-728)
    cam_preset: jax.Array    # int: -1 none, 0 = key 5 island, 1 = key 6 mountains
    set_aa_on: jax.Array     # bool: B held     (scene.cpp:750)
    set_aa_off: jax.Array    # bool: V held     (scene.cpp:753)

    @staticmethod
    def idle() -> "Action":
        """No keys held, no mouse motion."""
        z = np.int32(0)
        f = np.bool_(False)
        return Action(
            move_side=z, move_forward=z, move_up=z, run=f,
            mouse_dx=np.float32(0), mouse_dy=np.float32(0),
            time_control=z, set_play=f, set_pause=f, sea_control=z,
            time_preset=np.int32(-1), cam_preset=np.int32(-1),
            set_aa_on=f, set_aa_off=f,
        )

    # --- packed wire format -------------------------------------------------
    # Interactive loops ship one Action per frame to the device; sending 14
    # separate scalars costs 14 tiny host->device transfers per frame.
    # pack()/unpack() move the whole action as ONE (16,) f32 array instead.

    _PACK_FIELDS = ("move_side", "move_forward", "move_up", "run",
                    "mouse_dx", "mouse_dy", "time_control", "set_play",
                    "set_pause", "sea_control", "time_preset", "cam_preset",
                    "set_aa_on", "set_aa_off")

    def pack(self, dt: float = 0.0) -> np.ndarray:
        """One (16,) float32 vector (host-side; exact for all field ranges).

        Slot 14 carries the frame's dt so a step ships exactly one array."""
        v = np.zeros(16, np.float32)
        for i, name in enumerate(self._PACK_FIELDS):
            v[i] = np.float32(getattr(self, name))
        v[14] = np.float32(dt)
        return v

    @staticmethod
    def unpack_dt(v):
        return v[14]

    @staticmethod
    def unpack(v) -> "Action":
        """Rebuild an Action from a packed vector (device-side, inside jit)."""
        import jax.numpy as jnp

        f = Action._PACK_FIELDS
        g = {name: v[i] for i, name in enumerate(f)}
        return Action(
            move_side=g["move_side"].astype(jnp.int32),
            move_forward=g["move_forward"].astype(jnp.int32),
            move_up=g["move_up"].astype(jnp.int32),
            run=g["run"] > 0,
            mouse_dx=g["mouse_dx"], mouse_dy=g["mouse_dy"],
            time_control=g["time_control"].astype(jnp.int32),
            set_play=g["set_play"] > 0, set_pause=g["set_pause"] > 0,
            sea_control=g["sea_control"].astype(jnp.int32),
            time_preset=g["time_preset"].astype(jnp.int32),
            cam_preset=g["cam_preset"].astype(jnp.int32),
            set_aa_on=g["set_aa_on"] > 0, set_aa_off=g["set_aa_off"] > 0,
        )
