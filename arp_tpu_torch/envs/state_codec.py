"""Binary codec for the Procgen C++ engine's save-state blob.

Schema-driven re-implementation of the reference's hand-written reader/writer
pair (arp_dt/assets/{deserialize,serialize}.py) — the wire format is the C++
engine's little-endian struct dump (ints/floats/length-prefixed strings/
entity vectors, optional AISC extras, per-game trailing fields).  One schema
drives both directions, so encode(decode(x)) == x by construction.

Used to restore saved env states for goal-conditioned evaluation
(rollout: env.set_state(traj_state), reference rollout_procgen.py:99-108).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

INT = "i"
FLOAT = "f"
BOOL = "b"      # stored as int, exposed as bool
STRING = "s"    # int length + raw bytes
VEC_INT = "vi"  # int count + ints
ENTITIES = "ents"

ENTITY_SCHEMA: List[Tuple[str, str]] = [
    ("x", FLOAT), ("y", FLOAT),
    ("vx", FLOAT), ("vy", FLOAT),
    ("rx", FLOAT), ("ry", FLOAT),
    ("type", INT), ("image_type", INT), ("image_theme", INT),
    ("render_z", INT),
    ("will_erase", INT), ("collides_with_entities", INT),
    ("collision_margin", FLOAT), ("rotation", FLOAT), ("vrot", FLOAT),
    ("is_reflected", INT), ("fire_time", INT), ("spawn_time", INT),
    ("life_time", INT), ("expire_time", INT), ("use_abs_coords", INT),
    ("friction", FLOAT), ("smart_step", INT), ("avoids_collisions", INT),
    ("auto_erase", INT),
    ("alpha", FLOAT), ("health", FLOAT), ("theta", FLOAT),
    ("grow_rate", FLOAT), ("alpha_decay", FLOAT), ("climber_spawn_x", FLOAT),
]

HEADER_SCHEMA: List[Tuple[str, str]] = [
    ("SERIALIZE_VERSION", INT),
    ("game_name", STRING),
    ("paint_vel_info", INT),
    ("use_generated_assets", INT),
    ("use_monochrome_assets", INT),
    ("restrict_themes", INT),
    ("use_backgrounds", INT),
    ("center_agent", INT),
    ("debug_mode", INT),
    ("distribution_mode", INT),
    ("use_sequential_levels", INT),
]

AISC_SCHEMA: List[Tuple[str, str]] = [
    ("random_percent", INT),
    ("key_penalty", INT),
    ("step_penalty", INT),
    ("rand_region", INT),
    ("continue_after_coin", INT),
]

BODY_SCHEMA: List[Tuple[str, str]] = [
    ("use_easy_jump", INT),
    ("plain_assets", INT),
    ("physics_mode", INT),
    ("grid_step", INT),
    ("level_seed_low", INT),
    ("level_seed_high", INT),
    ("game_type", INT),
    ("game_n", INT),
    # randgen state = is_seeded int + serialized-stream string (flat keys,
    # matching the reference deserializer's dict schema)
    ("level_seed_is_seeded", INT),
    ("level_seed_str", STRING),
    ("rand_is_seeded", INT),
    ("rand_str", STRING),
    ("step_data_reward", FLOAT),
    ("step_data_done", INT),
    ("step_data_level_complete", INT),
    ("action", INT),
    ("timeout", INT),
    ("current_level_seed", INT),
    ("prev_level_seed", INT),
    ("episodes_remaining", INT),
    ("episodes_done", INT),
    ("last_reward_timer", INT),
    ("last_reward", FLOAT),
    ("default_action", INT),
    ("fixed_asset_seed", INT),
    ("cur_time", INT),
    ("is_waiting_for_sleep", INT),
    ("grid_size", INT),
    ("entities", ENTITIES),
    ("use_procgen_background", INT),
    ("background_index", INT),
    ("bg_tile_ratio", FLOAT),
    ("bg_pct_x", FLOAT),
    ("char_dim", FLOAT),
    ("last_move_action", INT),
    ("move_action", INT),
    ("special_action", INT),
    ("mixrate", FLOAT),
    ("maxspeed", FLOAT),
    ("max_jump", FLOAT),
    ("action_vx", FLOAT),
    ("action_vy", FLOAT),
    ("action_vrot", FLOAT),
    ("center_x", FLOAT),
    ("center_y", FLOAT),
    ("random_agent_start", INT),
    ("has_useful_vel_info", INT),
    ("step_rand_int", INT),
    ("asset_rand_is_seeded", INT),
    ("asset_rand_str", STRING),
    ("main_width", INT),
    ("main_height", INT),
    ("out_of_bounds_object", INT),
    ("unit", FLOAT),
    ("view_dim", FLOAT),
    ("x_off", FLOAT),
    ("y_off", FLOAT),
    ("visibility", FLOAT),
    ("min_visibility", FLOAT),
    ("grid_w", INT),
    ("grid_h", INT),
    ("grid_data", VEC_INT),
]

COINRUN_SCHEMA: List[Tuple[str, str]] = [
    ("last_agent_y", FLOAT),
    ("wall_theme", INT),
    ("has_support", BOOL),
    ("facing_right", BOOL),
    ("is_on_crate", BOOL),
    ("gravity", FLOAT),
    ("air_control", FLOAT),
]

MAZE_SCHEMA: List[Tuple[str, str]] = [
    ("maze_dim", INT),
    ("world_dim", INT),
]


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, kind: str):
        if kind == INT:
            (v,) = struct.unpack_from("<i", self.buf, self.pos)
            self.pos += 4
            return v
        if kind == FLOAT:
            (v,) = struct.unpack_from("<f", self.buf, self.pos)
            self.pos += 4
            return v
        if kind == BOOL:
            return self.read(INT) > 0
        if kind == STRING:
            n = self.read(INT)
            v = self.buf[self.pos : self.pos + n].decode()
            self.pos += n
            return v
        if kind == VEC_INT:
            n = self.read(INT)
            return [self.read(INT) for _ in range(n)]
        if kind == ENTITIES:
            n = self.read(INT)
            return [{name: self.read(k) for name, k in ENTITY_SCHEMA} for _ in range(n)]
        raise ValueError(kind)


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def write(self, kind: str, value):
        if kind == INT:
            self.parts.append(struct.pack("<i", int(value)))
        elif kind == FLOAT:
            self.parts.append(struct.pack("<f", float(value)))
        elif kind == BOOL:
            self.write(INT, 1 if value else 0)
        elif kind == STRING:
            raw = value.encode()
            self.write(INT, len(raw))
            self.parts.append(raw)
        elif kind == VEC_INT:
            self.write(INT, len(value))
            for v in value:
                self.write(INT, v)
        elif kind == ENTITIES:
            self.write(INT, len(value))
            for ent in value:
                for name, k in ENTITY_SCHEMA:
                    self.write(k, ent[name])
        else:
            raise ValueError(kind)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _full_schema(game_name: str, env_type: str) -> List[Tuple[str, str]]:
    schema = list(HEADER_SCHEMA)
    if "_" in game_name or env_type == "aisc":
        schema += AISC_SCHEMA
    schema += BODY_SCHEMA
    if "coinrun" in game_name:
        schema += COINRUN_SCHEMA
    elif "maze" in game_name:
        schema += MAZE_SCHEMA
    return schema


# The C++ engine terminates every save-state blob with this sentinel
# (reference serialize.py writes it; the deserializer stops just before it).
END_OF_BUFFER = 0xCAFECAFE - (1 << 32)  # as signed int32


def decode_state(buf: bytes, env_type: str = "none") -> Dict[str, Any]:
    """Decode an engine save-state blob to a field dict.

    The trailing END_OF_BUFFER sentinel, when present, is validated and
    consumed; blobs without it (e.g. reference-deserializer-era fixtures)
    still decode.
    """
    reader = _Reader(bytes(buf))
    data: Dict[str, Any] = {}
    for name, kind in HEADER_SCHEMA:
        data[name] = reader.read(kind)
    remaining = _full_schema(data["game_name"], env_type)[len(HEADER_SCHEMA):]
    for name, kind in remaining:
        data[name] = reader.read(kind)
    if len(reader.buf) - reader.pos >= 4:
        sentinel = reader.read(INT)
        if sentinel != END_OF_BUFFER:
            raise ValueError(
                f"bad end-of-buffer sentinel {sentinel & 0xFFFFFFFF:#x} "
                f"(schema mismatch for {data['game_name']!r}/{env_type!r}?)"
            )
    return data


def encode_state(data: Dict[str, Any], env_type: str = "none") -> bytes:
    """Encode a field dict back to the engine's wire format (incl. sentinel)."""
    writer = _Writer()
    for name, kind in _full_schema(data["game_name"], env_type):
        writer.write(kind, data[name])
    writer.write(INT, END_OF_BUFFER)
    return writer.getvalue()
