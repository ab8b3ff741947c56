"""Inline JAX dispatch for the port's tests that run interpret-mode Pallas.

Interpret-mode Pallas calls back into JAX from its io_callbacks; with the
CPU client's asynchronous dispatch such a callback and the next eager
dispatch can wait on each other forever (seen under pytest-xdist).  Inline
dispatch cannot.  The setting takes effect only before the CPU client is
made, so a test module imports this one at its top, at collection: the
first import sets it for the whole process.
"""

import jax

jax.config.update("jax_cpu_enable_async_dispatch", False)
