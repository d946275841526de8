"""Weight import, train state, schedules, the pretrain step and the eval forward."""
