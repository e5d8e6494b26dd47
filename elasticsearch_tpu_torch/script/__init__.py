from elasticsearch_tpu_torch.script.expressions import ExpressionScript, compile_script

__all__ = ["ExpressionScript", "compile_script"]
