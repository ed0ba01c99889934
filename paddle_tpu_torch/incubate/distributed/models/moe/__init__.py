"""MoE of the port (port of paddle_tpu/incubate/distributed/models/moe)."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, moe_capacity
from .moe_layer import ExpertFFN, MoELayer

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate", "MoELayer",
           "ExpertFFN", "moe_capacity"]
