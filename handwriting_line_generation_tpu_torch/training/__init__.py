"""Trainers of the port: ``hwr_trainer.HWRTrainer`` (HWR pretraining)."""
