"""Operations and bytes of the port's kernels K1 (the fused rollout turn)
and K3 (RM+), frozen from ``rnad_tpu_torch/ops/fused_turn.py`` and
``ops/rmplus.py`` (``operations``, ``io_bytes``), and the bound of each
kernel's launches in one train step."""

from __future__ import annotations

from .peaks import Work


def fused_turn_operations(A: int, H: int) -> int:
    """One (lane, seat) row of K1, an FMA counting two: the first layer
    (din * H) and the block-diagonal second, W * (A + 1) in all."""
    return 2 * (2 * A * A * H + H // 2 * (A + 1))


def fused_turn_io_bytes(B: int, A: int, T: int, H: int, rows: int,
                        cells: int, weight_bytes: int = 4,
                        store_obs: bool = False) -> int:
    """Each lane's index and noise read and its outputs written once (and
    its two observations under ``store_obs``), each distinct state's two
    observations and masks, each distinct played cell's T log-chances,
    child and value, and the weights and biases once."""
    din = 2 * A * A
    return (4 * (B + rows * (2 * din + 2 * A) + cells * (T + 2)
                 + H + A + 1
                 + 2 * B * A + B * T
                 + B + 2 * B * A + 2 * B + B + 2 * B
                 + (2 * B * din if store_obs else 0))
            + weight_bytes * (din * H + H * (A + 1)))


def rmplus_operations(R: int, C: int, iters: int) -> int:
    """One game's RM+ solve on 0/1 masks (the products by the mask are
    exact no-ops and not counted)."""
    per_iter = 4 * R * C + 10 * R + 11 * C + 3
    return iters * per_iter + 3 * (R + C) + 2 + 3 * R * C


def rmplus_io_bytes(R: int, C: int, B: int) -> int:
    """M and both masks read once, x, y and v written once."""
    return 4 * B * (R * C + R + C + R + C + 1)


def k1_step(config: dict, lanes: int, levels: int, rows: float,
            cells: float) -> Work:
    """K1's launches in one step (one a turn) as one function over the
    rollout's ``levels`` turns: its products at the actor's operand type,
    and its bytes from the distinct states and played cells."""
    net, cfg = config["net"], config["rnad"]
    A, T = config["tree"]["max_actions"], config["tree"]["max_transitions"]
    H = 2 * net["width"]
    actor = cfg.get("rollout_actor_dtype", "float32")
    n = lanes * levels
    return Work({actor: 2.0 * n * fused_turn_operations(A, H)},
                float(fused_turn_io_bytes(
                    n, A, T, H, rows, cells, 2 if actor == "bfloat16" else 4,
                    cfg.get("store_rollout_obs", True))))


def k3_step_bound_s(config: dict, lanes: int, levels: int) -> float:
    """The least time of K3's launches in one step of a solver EquiNet:
    one a rollout turn over both seats' 2B games, one over the learner's
    2 levels B observations, each the larger of its operations (float32)
    and its bytes."""
    from .peaks import FLOPS, HBM_BYTES_PER_S

    A, iters = config["tree"]["max_actions"], config["net"]["solver_iters"]
    launches = [2 * lanes] * levels + [2 * levels * lanes]
    return sum(max(g * rmplus_operations(A, A, iters) / FLOPS["float32"],
                   rmplus_io_bytes(A, A, g) / HBM_BYTES_PER_S)
               for g in launches)
