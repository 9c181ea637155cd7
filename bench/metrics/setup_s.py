"""Seconds from process start to the window's start: data, the index build
(the wave executor), the engine and the warm-up of the window's shapes."""


def read(obs):
    return obs.setup_s
