"""Trained policies shipped with the port, as .npz files of the actor's
weights and its observation normalizer (see rl/networks.py:load_actor),
and the motion clip the tracking policy was trained on."""

from pathlib import Path

G1_FLAT_POLICY = Path(__file__).parent / 'g1_flat' / 'model_4500.npz'
G1_TRACKING_POLICY = (Path(__file__).parent / 'g1_tracking'
                      / 'model_6000.npz')
G1_TRACKING_MOTION = (Path(__file__).parent / 'g1_tracking'
                      / 'g1_walk_turn_50hz.npz')
