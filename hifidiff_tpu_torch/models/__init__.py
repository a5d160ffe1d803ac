"""Models of the refiner sampler: CR, IDC, FPG, FusedDenoiser, FacialRefiner,
and the tiny distilled CR."""
