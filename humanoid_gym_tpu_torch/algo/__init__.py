"""Actor-critic nets and PPO for the PyTorch port."""
