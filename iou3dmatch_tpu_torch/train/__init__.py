"""Weight import, train state, schedules, the pretrain and SSL steps and the eval forward."""
