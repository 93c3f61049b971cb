"""Trained policies shipped with the port, as .npz files of the actor's
weights and its observation normalizer (see rl/networks.py:load_actor)."""

from pathlib import Path

G1_FLAT_POLICY = Path(__file__).parent / 'g1_flat' / 'model_4500.npz'
