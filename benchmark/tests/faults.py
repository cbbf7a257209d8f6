"""Faults planted under the timed path, for the check's own tests: each
is an ``app_hook`` for ``run.main``, applied to the built app before the
warm-up."""

import jax.numpy as jnp


def _radios(app):
    from sdrplusplusbrown_tpu.app import RadioModuleInstance
    return [m for m in app.modules.values()
            if isinstance(m, RadioModuleInstance)]


def state_unchanged(app):
    """Every radio's step hands back the state it was given."""
    for m in _radios(app):
        step = m.jit_step
        m.jit_step = lambda p, s, x, step=step: (step(p, s, x)[0], s)


def half_left_out(app):
    """Half of the radios are not run."""
    radios = _radios(app)
    for m in radios[:max(1, len(radios) // 2)]:
        m.disable()


def answer_altered(app):
    """One audio sample of every block is off by 0.05 where the radio
    produces it."""
    for m in _radios(app):
        step = m.jit_step

        def altered(p, s, x, step=step):
            y, s2 = step(p, s, x)
            return y.at[..., 100].add(jnp.float32(0.05)), s2
        m.jit_step = altered
