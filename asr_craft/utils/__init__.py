from asr_craft.utils.logging import MetricsLogger
