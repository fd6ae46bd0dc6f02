"""Run identity of the port (the slice of ``sgcn_tpu/obs`` ported so far).

``recorder.plan_digest`` / ``plan_manifest_block``: the comm plan's 16-hex
identity that checkpoint provenance records.  The run recorder, the event
stream and the memory model are ROADMAP A10.
"""

from .recorder import plan_digest, plan_manifest_block

__all__ = ["plan_digest", "plan_manifest_block"]
