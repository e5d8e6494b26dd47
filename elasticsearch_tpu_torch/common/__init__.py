"""Host-side building blocks copied from the reference (errors, knobs,
fault injection, the device-memory ledger, engine health)."""
