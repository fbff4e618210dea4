"""The web demos (counterparts of web-demos/hugging_face/app.py and
web-demos/replicate/predict.py): the restore flow as a function, with
the gradio UI and the cog predictor built only where those packages
import."""
