from .boxes import bbox_cwh_to_ulbr
from .camera import rdf_T_flu
from .egomotion import unicycle_now_T_prev

__all__ = ["bbox_cwh_to_ulbr", "rdf_T_flu", "unicycle_now_T_prev"]
