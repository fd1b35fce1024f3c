// Login page (reference pages/logIn).
import { api, esc, t } from "../app.js";

export async function viewLogin(app) {
  document.getElementById("nav").hidden = true;
  document.getElementById("logout").hidden = true;
  document.getElementById("user").textContent = "";
  app.innerHTML = `
    <div class="panel" id="login-view">
      <h2>${esc(t("login.title"))}</h2>
      <div class="row"><input id="u" placeholder="username"
           autocomplete="username"></div>
      <div class="row"><input id="p" placeholder="password" type="password"
           autocomplete="current-password"></div>
      <div class="row"><button class="primary" id="go">
        ${esc(t("login.button"))}</button>
        <span id="err" class="error"></span></div>
    </div>`;
  const submit = async () => {
    try {
      await api("/login", { method: "POST", body: JSON.stringify({
        username: document.getElementById("u").value,
        password: document.getElementById("p").value }) });
      location.hash = "#/jobs";
    } catch (e) {
      document.getElementById("err").textContent = t("login.failed");
    }
  };
  document.getElementById("go").onclick = submit;
  document.getElementById("p").onkeydown = e => {
    if (e.key === "Enter") submit();
  };
}
