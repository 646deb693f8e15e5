"""The paper's own workload: NetLogo 'ants' foraging model (Wilensky 1999).

Parameters per the paper (§4): population (number of ants), evaporation-rate,
diffusion-rate; 3 food sources at increasing distances from the nest;
objectives = first tick at which each source empties.

The port's own copy of ``repro.configs.ants_netlogo``: the two packages share
no module, so a change to one is made to both.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class AntsConfig:
    world_size: int = 72          # NetLogo default world is 71x71 patches
    population: int = 125         # paper default gPopulation := 125
    max_ticks: int = 1000         # simulation horizon (objective cap)
    nest_radius: float = 5.0
    food_radius: float = 5.0
    # food source distances from center, NetLogo ants.nlogo layout
    diffusion_rate: float = 50.0  # paper default
    evaporation_rate: float = 50.0
    chem_dtype: str = "float32"   # perf knob: bf16 halves field memory traffic


CONFIG = AntsConfig()

# Reduced config for CPU tests / quickstart: small world, short horizon,
# small food discs so the nearest source empties within the horizon.
REDUCED = AntsConfig(world_size=32, population=64, max_ticks=300,
                     food_radius=3.0)

# Calibration bounds, exactly the paper's Listing 4/5:
#   gDiffusionRate  in (0.0, 99.0)
#   gEvaporationRate in (0.0, 99.0)
BOUNDS = ((0.0, 99.0), (0.0, 99.0))
