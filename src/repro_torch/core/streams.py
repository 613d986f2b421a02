"""Central registry of the private PRNG stream tags.

Every subsystem that needs its own randomness derives a stream base key by
folding a *stream tag* into the per-seed base key:

    stream_key = fold_in(PRNGKey(seed), TAG)

and then folds the round index into that stream key per round. The tags
therefore must (a) be unique — two subsystems folding the same tag would
silently correlate their draws — and (b) sit far above any realistic round
index, so the fading stream's ``fold_in(base, round)`` (which uses the
*unfolded* base key) can never collide with another stream's base.

This module is the port's copy of the JAX package's tag registry
(``repro_torch.random`` supplies ``fold_in``/``PRNGKey``): the values must
stay identical, so the port draws the reference's exact streams. Add new
subsystem streams here and in the reference together.

Sub-streams *within* a subsystem (e.g. the crash/corrupt/churn draws of
``repro.core.faults.inject``, or the burst/outage draws of
``repro.core.link.model``) are small integers folded into that subsystem's
already-unique stream key *before* the round index — they need only be
unique within their subsystem and are documented where they live.
"""
from __future__ import annotations

# the fading stream uses the per-seed base key itself (folded by round);
# ROUND_SAFETY_MARGIN is the ceiling on round indices the tag spacing
# protects against (1 << 20 rounds ~ a million — far beyond any run)
ROUND_SAFETY_MARGIN = 1 << 20

CTRL_STREAM = 1 << 20      # controller per-round keys (repro.fl.server)
SAMPLE_STREAM = 2 << 20    # client minibatch sampling (repro.fl.server)
HARVEST_STREAM = 3 << 20   # energy-harvesting draws (repro.core.rounds)
FAULT_STREAM = 4 << 20     # crash/corrupt/churn/h_est (repro.core.faults)
POOL_STREAM = 5 << 20      # hierarchy candidate-pool sampler base key
MOBILITY_STREAM = 6 << 20  # pathloss-drift phases (repro.core.channel)
LINK_STREAM = 7 << 20      # burst interference + outage (repro.core.link)

STREAMS: dict[str, int] = {
    "ctrl": CTRL_STREAM,
    "sample": SAMPLE_STREAM,
    "harvest": HARVEST_STREAM,
    "fault": FAULT_STREAM,
    "pool": POOL_STREAM,
    "mobility": MOBILITY_STREAM,
    "link": LINK_STREAM,
}


def validate_streams(streams: dict[str, int] = None) -> None:
    """Raise if any two stream tags collide or a tag sits inside the
    round-index range (where ``fold_in(base, round)`` of the fading
    stream could reproduce it). Runs at import so a bad registration
    fails the first time anything touches the engine."""
    streams = STREAMS if streams is None else streams
    seen: dict[int, str] = {}
    for name, tag in streams.items():
        if not isinstance(tag, int):
            raise TypeError(f"stream {name!r} tag must be an int, got "
                            f"{type(tag).__name__}")
        if tag < ROUND_SAFETY_MARGIN:
            raise ValueError(
                f"stream {name!r} tag {tag} is below the round-index "
                f"safety margin {ROUND_SAFETY_MARGIN}: the fading "
                f"stream's fold_in(base, round) could collide with it")
        if tag in seen:
            raise ValueError(f"stream tag collision: {name!r} and "
                             f"{seen[tag]!r} both fold {tag}")
        seen[tag] = name


validate_streams()
