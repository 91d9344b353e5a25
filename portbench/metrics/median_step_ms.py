"""ms a training step of the window's median episode: beside
train_step_ms (the whole window over its steps), a reading that one slow
stretch of the shared host does not move."""

from portbench import readers


def read(ctx):
    return readers.median_episode_ms(ctx)
