"""galileo_sdr_sim_tpu: Galileo E1 OS baseband signal simulator on JAX.

A from-scratch JAX/XLA re-architecture of the capabilities of
harshadms/galileo-sdr-sim: RINEX-driven Galileo E1B/C (BOC(1,1), live
I/NAV) baseband synthesis at 2.6 Msps int16 I/Q, with file and SDR sinks,
live position/bit-stream inputs, and satellite/time sharding across
device meshes.  It runs on one NVIDIA H100 (or several); the package
name dates from the system's first build, for a TPU.
"""

__version__ = "0.1.0"
