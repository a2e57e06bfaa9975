"""Multi-device rendering (mirrors hybrid_rendering_tpu/parallel): a mesh
is an ordered list of devices, the three tracers shard their ray batches
over it, and the GT path tracer traces each row block on its own device."""
