"""Models: the Gaussian store, time-Fourier colours, splatfacto helpers
(SH colours, sky) and the scene graph."""
