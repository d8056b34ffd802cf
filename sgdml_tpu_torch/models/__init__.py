"""Model artifact wrapper and its carry-over to torch tensors."""

from .gdml import GDMLModel, as_model_dict, model_to_torch

__all__ = ['GDMLModel', 'as_model_dict', 'model_to_torch']
